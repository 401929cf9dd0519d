"""The port's Gradio app (``blobctrl_torch.apps.gradio_app.build_demo``)
against the JAX app's, both built on ``tests/gradio_stub.py`` (gradio is
not installed): the same widgets and events in the same order with the
same outputs, and every handler, driven through the same session steps
with the ``FakeSam`` double, returns what the JAX handler returns (arity,
order and images; the generated results to the session test's bar, the
two pipelines running on the same weights from the same seed). The
example gallery replays from an ``examples_root`` that the test writes.
``main`` loads through the port's loaders: a present SAM checkpoint is
wrapped in the port's ``SamPredictor`` for the session, and one that
cannot be read fails loudly."""

import os
import pickle

import numpy as np
import pytest
import torch

from blobctrl_tpu.apps import gradio_app as jgradio
from blobctrl_tpu.apps import session as jsession
from blobctrl_torch.apps import gradio_app as tgradio
from blobctrl_torch.apps import session as tsession
from tests import gradio_stub
from tests.test_gradio_wiring import FakeSam
from tests.test_torch_session import Recorded, pipelines  # noqa: F401
from tests.test_torch_session import SIZE, _assert_u8_close


def _write_example(root, name):
    """A demo state saved by the port's session, with a results gallery."""
    s = tsession.BlobCtrlSession(None, size=SIZE, device="cpu")
    yy, xx = np.mgrid[:SIZE, :SIZE]
    s.set_image(np.stack([xx * 3, yy * 3, xx + yy], -1).astype(np.uint8))
    s.set_mask(((((xx - 30) / 10.0) ** 2 + ((yy - 28) / 7.0) ** 2) <= 1)
               .astype(np.uint8) * 255)
    s.generate_blob()
    s.add_tracking_point(30, 28)
    s.add_tracking_point(38, 34)
    d = os.path.join(root, name)
    s.save_state(d, prompt="a toy", seed=5, blobnet_control_strength=1.1)
    from blobctrl_torch.utils import png
    os.makedirs(os.path.join(d, "results_gallery"))
    with open(os.path.join(d, "results_gallery", "r_0.png"), "wb") as f:
        f.write(png.encode_png(s.original_image))


@pytest.fixture(scope="module")
def demos(pipelines, tmp_path_factory):  # noqa: F811
    root = str(tmp_path_factory.mktemp("examples"))
    _write_example(root, "move_hat")
    jpipe, tpipe = pipelines
    gradio_stub.install()
    try:
        js = jsession.BlobCtrlSession(Recorded(jpipe), sam_predictor=FakeSam(),
                                      size=SIZE)
        ts = tsession.BlobCtrlSession(Recorded(tpipe), sam_predictor=FakeSam(),
                                      size=SIZE)
        jd = jgradio.build_demo(js, root)
        td = tgradio.build_demo(ts, root)
        yield (jd, js), (td, ts)
    finally:
        gradio_stub.uninstall()


def _labels(comps):
    return [(type(c).__name__, c.label) for c in comps]


def test_same_widgets_and_event_graph(demos):
    (jd, _), (td, _) = demos
    assert _labels(td.components) == _labels(jd.components)
    assert len(td.events) == len(jd.events) >= 17
    for te, je in zip(td.events, jd.events):
        assert (te.name, te.component.label) == (je.name, je.component.label)
        assert _labels(te.inputs) == _labels(je.inputs)
        assert _labels(te.outputs) == _labels(je.outputs)
    comp_ids = {id(c) for c in td.components}
    assert all(id(o) in comp_ids for e in td.events for o in e.outputs)


def _same(a, b, path="out", results=False):
    if isinstance(b, np.ndarray) or isinstance(a, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, path
        if results:
            _assert_u8_close(a / 255.0, b / 255.0, path)
        else:
            np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(b, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]", results)
    else:
        assert a == b, (path, a, b)


def _invoke(demos, name, label, *args, results=False):
    (jd, _), (td, _) = demos
    je, te = jd.find_event(name, label), td.find_event(name, label)
    gradio_stub.WARNINGS.clear()
    want = je.fn(*args)
    jw = list(gradio_stub.WARNINGS)
    gradio_stub.WARNINGS.clear()
    got = te.fn(*args)
    assert list(gradio_stub.WARNINGS) == jw
    n = len(got) if isinstance(got, tuple) else 1
    assert n == len(te.outputs), (label, name, n, len(te.outputs))
    _same(got, want, f"{label}.{name}", results)
    return got


def test_every_handler_matches_jax(demos):
    gr = gradio_stub
    (_, js), (_, ts) = demos
    img = np.full((80, 90, 3), 200, np.uint8)
    img[20:60, 25:65] = 60
    _invoke(demos, "upload", "Input", None)
    _invoke(demos, "upload", "Input", img)
    _invoke(demos, "select", "Input", gr.SelectData((32, 32)))
    _invoke(demos, "click", "Undo Seg")
    _invoke(demos, "select", "Input", gr.SelectData((30, 30)))
    _invoke(demos, "select", "Input", gr.SelectData((5, 60)))
    _invoke(demos, "click", "Undo Seg")
    _invoke(demos, "click", "Generate Blob")
    assert ts.editor.entries == js.editor.entries
    blob = "Editable Blob"
    _invoke(demos, "select", blob, gr.SelectData((2, 2)))     # guard warns
    cx, cy = (int(v) for v in ts.editor.current[0])
    _invoke(demos, "select", blob, gr.SelectData((cx, cy)))
    _invoke(demos, "select", blob, gr.SelectData((cx + 6, cy - 3)))
    _invoke(demos, "select", blob, gr.SelectData((cx + 9, cy + 4)))
    _invoke(demos, "click", "Undo Point")
    _invoke(demos, "click", "Reset Points")
    _invoke(demos, "release", "Resize (aspect", 1.1)
    _invoke(demos, "release", "long axis", 1.05)
    _invoke(demos, "release", "short axis", 0.9)
    _invoke(demos, "release", "START", 1.05)
    _invoke(demos, "release", "Rotate", 10.0)
    _invoke(demos, "change", "Remove mode", True)
    _invoke(demos, "change", "Remove mode", False)
    assert ts.editor.entries == js.editor.entries
    _invoke(demos, "click", "Run Generation", "a red ball", 1.2, 0.0, 1.0, 7,
            1, 7.5, 2, False, False, results=True)
    _invoke(demos, "click", "Run Generation", "a red ball", 1.2, 0.0, 1.0, 7,
            1, 7.5, 2, True, False, results=True)
    _invoke(demos, "click", "Set Init Ellipse", "[0.5, 0.5, 0.3, 0.25, 0]")
    _invoke(demos, "click", "Set Init Ellipse", "[1, 2]")       # warns
    obj = np.full((80, 80, 3), 255, np.uint8)
    obj[20:60, 20:60] = 30
    _invoke(demos, "upload", "Object image", obj)
    _invoke(demos, "upload", "Object image", None)
    # guards on an empty editor
    for s in (js, ts):
        s.editor.entries = []
    _invoke(demos, "release", "Rotate", 10.0)
    _invoke(demos, "release", "Resize (aspect", 1.1)
    _invoke(demos, "release", "START", 1.1)
    _invoke(demos, "click", "Undo Point")
    _invoke(demos, "click", "Reset Points")
    _invoke(demos, "change", "Remove mode", True)
    _invoke(demos, "upload", "Object image", obj)               # warns


def test_example_replay_event(demos):
    ret = _invoke(demos, "click", "Load Example", "move_hat")
    assert len(ret) == 12 and ret[6] == "a toy" and ret[7] == 1.1
    (_, js), (_, ts) = demos
    assert ts.editor.entries == js.editor.entries
    assert ts.tracking_points == [[30, 28], [38, 34]]


def test_main_loads_through_the_port(monkeypatch, tmp_path):
    from blobctrl_torch.params import io as tio
    seen = {}

    def fake_load(root, dtype=None, device="cuda"):
        seen["load"] = (root, device)
        return None

    monkeypatch.setattr(tio, "load_pipeline", fake_load)
    launched = []

    class Demo:
        def __init__(self, session, root):
            self.session = session

        def launch(self, server_port):
            launched.append((self.session, server_port))
    monkeypatch.setattr(tgradio, "build_demo", Demo)
    os.makedirs(tmp_path / "sam")
    path = tmp_path / "sam" / "sam_vit_h_4b8939.pth"
    path.write_bytes(b"x")
    with pytest.raises(pickle.UnpicklingError):
        tgradio.main(["--models_root", str(tmp_path), "--device", "cpu"])
    assert seen["load"] == (str(tmp_path), "cpu") and not launched
    # a real (tiny) checkpoint in the original key format
    from blobctrl_torch.models import sam as tsam
    from blobctrl_torch.params import export
    tree = tsam.init(tsam.SAMConfig(hidden_size=32, num_layers=2,
                                    num_heads=2, mlp_dim=64, image_size=64,
                                    window_size=2, global_attn_indexes=(1,),
                                    output_channels=16, prompt_dim=16,
                                    decoder_heads=2, decoder_mlp_dim=32),
                     key=1, device="cpu")
    export.save_sam(str(path), tree)
    tgradio.main(["--models_root", str(tmp_path), "--device", "cpu"])
    (session, _), = launched
    assert isinstance(session.sam, tsam.SamPredictor)
    assert session.sam.device.type == "cpu"
    assert torch.equal(session.sam.params["vision"]["pos_embed"],
                       tree["vision"]["pos_embed"])
