"""``apps.server.EditService.close`` ends the micro-batcher thread, so a
closed service stops holding its pipeline (a script that serves, then goes
on to train, gets the card's memory back), and a request still queued
fails instead of waiting forever, as does a request made after the
close."""

import gc
import threading
import time
import types
import weakref

import pytest

from blobctrl_torch.apps import server


class Pipe:
    unet_cfg = types.SimpleNamespace(cross_attention_dim=16)


def _batchers():
    return [t for t in threading.enumerate() if t.name == "edit-batcher"]


def test_close_ends_the_batcher_and_releases_the_pipeline():
    before = len(_batchers())
    pipe = Pipe()
    svc = server.EditService(pipe, size=64, max_batch=4)
    assert len(_batchers()) == before + 1
    queued = server._BatchItem("group", {}, {})
    with svc._queue_cv:  # a request the batcher has not taken yet
        svc._closed = True
        svc._queue.append(queued)
        svc._queue_cv.notify_all()
    svc.close()
    assert queued.event.wait(10)
    assert isinstance(queued.error, RuntimeError)
    for t in _batchers()[before:]:
        t.join(10)
    assert len(_batchers()) == before
    ref = weakref.ref(pipe)
    del svc, pipe
    gc.collect()
    assert ref() is None


def test_edit_after_close_fails_at_once():
    svc = server.EditService(Pipe(), size=64, max_batch=4)
    svc.close()
    svc._parse = lambda req: ({}, {}, {  # a request the batcher would take
        "num_samples": 1, "encoder_cache_interval": 0, "remove": False,
        "preview": False, "gs_channels": 1})
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="closed"):
        svc.edit({})
    assert time.monotonic() - t0 < svc.BATCH_WAIT_TIMEOUT_S
    assert not svc._queue
