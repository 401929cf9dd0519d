"""The port's latent previews (``pipeline/preview.py``) bit-equal to the
JAX package's, errors included, and its observability helpers
(``utils/observability.py``) on the CPU."""

import json
import logging
import os

import numpy as np
import pytest
import torch

from blobctrl_tpu.pipeline import preview as jpreview
from blobctrl_torch.pipeline import preview as tpreview
from blobctrl_torch.utils import observability as obs

torch.set_num_threads(2)


@pytest.mark.parametrize("shape,kw", [
    ((2, 8, 8, 4), {}), ((8, 16, 4), {"upscale": 2}),
    ((1, 8, 16, 4), {"out_width": 8, "upscale": 8}),
    ((3, 5, 7, 4), {"out_width": 1})])
def test_latent_to_rgb_bit_equal(shape, kw):
    x = (np.random.RandomState(0).randn(*shape) * 3).astype(np.float32)
    want = jpreview.latent_to_rgb(x, **kw)
    got = tpreview.latent_to_rgb(x, **kw)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,kw", [((2, 8, 8, 3), {}), ((8, 4), {}),
                                      ((1, 8, 8, 4), {"out_width": 9}),
                                      ((1, 8, 8, 4), {"out_width": 0})])
def test_latent_to_rgb_errors_match(shape, kw):
    x = np.zeros(shape, np.float32)
    with pytest.raises(ValueError) as want:
        jpreview.latent_to_rgb(x, **kw)
    with pytest.raises(ValueError) as got:
        tpreview.latent_to_rgb(x, **kw)
    assert str(got.value) == str(want.value)


def test_log_event_and_step_timer(caplog):
    with caplog.at_level(logging.INFO, logger="blobctrl_torch"):
        obs.log_event("unit", a=1, b="x")
        t = obs.StepTimer()
        for _ in range(2):
            with t.phase("work", sync_on=torch.zeros(2)):
                torch.ones(64).sum()
        t.report()
    events = [json.loads(r.getMessage()) for r in caplog.records]
    assert events[0] == {"event": "unit", "a": 1, "b": "x"}
    assert events[-1]["event"] == "step_timer" and "work" in events[-1]
    s = t.summary()["work"]
    assert s["count"] == 2 and s["total_s"] >= 0


def test_profile_breakdown_and_trace_on_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the CPU breakdown (host times of operators)")
    a = torch.randn(64, 64)

    def work(x):
        with obs.annotate("blobctrl_mm"):
            return torch.relu(x @ x)
    got = obs.profile_op_breakdown(work, a, repeats=2)
    assert got and all(v >= 0 for v in got.values())
    assert any("mm" in k for k in got), got
    with obs.trace(str(tmp_path)) as d:
        work(a)
    trace = json.load(open(os.path.join(d, "trace.json")))
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "blobctrl_mm" in names
