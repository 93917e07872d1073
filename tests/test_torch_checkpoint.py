"""The port's checkpointer and fault tolerance, on the CPU.

``checkpoint/checkpointer.py``: a param tree saved and restored bitwise
(bf16 included) with no ``.tmp`` residue, the GC keeping 3, the manifest
of a flat dict tree (keys, files, shapes, logical dtypes) equal to what
the JAX package's ``save`` writes for it, the same bytes in each file,
and each package restoring the other's checkpoint; ``runtime/fault_tolerance.py``: a restart resuming
from the latest checkpoint (``fail_at=[7]``, as the reference's test)
with the losses of an uninterrupted run, the supervisor giving up after
2 restarts, the watchdog flagging a straggler on an injected clock.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpointer as jckpt
from repro_torch import tree
from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.configs import get_config
from repro_torch.models import convert
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.runtime.fault_tolerance import (FailureInjector, Supervisor,
                                                 Watchdog)
from repro_torch.train import loop


def _params():
    cfg = get_config("gemma2-2b").reduced()
    return cfg, M.init(cfg, torch.Generator().manual_seed(0), "cpu")


def test_checkpoint_roundtrip_and_atomicity(tmp_path):
    cfg, params = _params()
    state = {"params": params, "opt": adamw.init(params)}
    d = str(tmp_path)
    path = ckpt.save(d, 3, state)
    assert path.endswith("step_00000003")
    assert ckpt.latest_step(d) == 3
    assert not [f for f in os.listdir(d) if f.endswith(".tmp")]
    loaded = ckpt.restore(d, 3, state)
    got, want = tree.paths(loaded), tree.paths(state)
    assert [p for p, _ in got] == [p for p, _ in want]
    assert any(t.dtype == torch.bfloat16 for _, t in want)
    for (_, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and a.device == b.device
        assert torch.equal(a, b)


def test_a_stale_tmp_is_not_a_step(tmp_path):
    d = str(tmp_path)
    os.makedirs(os.path.join(d, "step_00000009.tmp"))
    ckpt.save(d, 4, {"x": torch.arange(3)})
    assert ckpt.list_steps(d) == [4]
    ckpt.save(d, 9, {"x": torch.arange(3)})
    assert ckpt.list_steps(d) == [4, 9]
    assert not os.path.exists(os.path.join(d, "step_00000009.tmp"))


@pytest.mark.parametrize("keep,want", [(3, [2, 3, 4]), (2, [3, 4])])
def test_async_checkpointer_gc(tmp_path, keep, want):
    saver = ckpt.AsyncCheckpointer(str(tmp_path), keep=keep)
    x = torch.arange(10)
    for s in range(5):
        saver.save(s, {"x": x})
        x.add_(1)                  # the snapshot was taken before this
    saver.wait()
    assert ckpt.list_steps(str(tmp_path)) == want
    got = ckpt.restore(str(tmp_path), 4, {"x": x})
    assert torch.equal(got["x"], torch.arange(10) + 4)


def _flat():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 6)).astype(np.float32)
    return {"w": x, "h": x[:2].copy(), "step": np.int32(7),
            "q": (x * 10).astype(np.int8)}


def test_manifest_matches_the_reference_and_each_restores_the_other(
        tmp_path):
    """A flat dict tree (fp32, bf16, int32, int8 leaves) saved by both
    packages: the same manifest, the same bytes in each file, and each
    restores the other's checkpoint bitwise."""
    flat = _flat()
    jtree = {"w": jnp.asarray(flat["w"]),
             "h": jnp.asarray(flat["h"]).astype(jnp.bfloat16),
             "step": jnp.asarray(flat["step"]),
             "q": jnp.asarray(flat["q"])}
    ttree = {k: convert.tensor(np.asarray(v), "cpu")
             for k, v in jtree.items()}
    jd, td = str(tmp_path / "jax"), str(tmp_path / "torch")
    jckpt.save(jd, 1, jtree)
    ckpt.save(td, 1, ttree)
    manifests = [json.load(open(os.path.join(d, "step_00000001",
                                             "manifest.json")))
                 for d in (jd, td)]
    assert manifests[0] == manifests[1]
    assert {k: v["dtype"] for k, v in manifests[1]["leaves"].items()} == {
        "w": "float32", "h": "bfloat16", "step": "int32", "q": "int8"}
    for meta in manifests[1]["leaves"].values():
        a, b = (np.load(os.path.join(d, "step_00000001", meta["file"]))
                for d in (jd, td))
        assert a.shape == b.shape and a.tobytes() == b.tobytes()
        # bf16: the port stores uint16; the reference's file holds numpy's
        # raw 2-byte void, since ml_dtypes puts bfloat16 in np.sctypeDict
        # and its uint16 branch does not run (ROADMAP C.28)
        assert (a.dtype.itemsize, b.dtype) == (2, np.uint16) \
            if meta["dtype"] == "bfloat16" else a.dtype == b.dtype
    got = ckpt.restore(jd, 1, ttree)
    for k in ttree:
        assert got[k].dtype == ttree[k].dtype
        assert torch.equal(got[k], ttree[k])
    back = jckpt.restore(td, 1, jtree)
    for k in jtree:
        assert back[k].dtype == jtree[k].dtype
        assert np.asarray(back[k]).tobytes() == \
            np.asarray(jtree[k]).tobytes()


def test_restart_resumes_from_checkpoint(tmp_path):
    """A failure injected at step 7 restarts once, from the latest whole
    checkpoint: step 6's, or step 3's where step 6's background write had
    not been renamed into place yet (it is never half read); the run ends
    at step 9 with step 9 saved, and every step's loss, the re-run ones
    too, is the uninterrupted run's, bit for bit."""
    cfg = get_config("gemma2-2b").reduced()
    d = str(tmp_path)
    inj = FailureInjector(fail_at=[7])
    res = loop.train(cfg, steps=10, batch_size=2, seq_len=16, ckpt_dir=d,
                     ckpt_every=3, injector=inj, log_every=1000,
                     device="cpu")
    assert res["restarts"] == 1
    steps_seen = [h["step"] for h in res["history"]]
    resumed = steps_seen[7]
    assert resumed in (4, 7)
    assert steps_seen == list(range(7)) + list(range(resumed, 10))
    assert ckpt.latest_step(d) == 9
    assert ckpt.list_steps(d) == [3, 6, 9]
    plain = loop.train(cfg, steps=10, batch_size=2, seq_len=16,
                       log_every=1000, device="cpu")
    want = [h["loss"] for h in plain["history"]]
    assert [h["loss"] for h in res["history"]] == \
        [want[s] for s in steps_seen]
    final = ckpt.restore(d, 9, {"params": res["params"]})["params"]
    for a, b in zip(tree.leaves(final), tree.leaves(res["params"])):
        assert torch.equal(a, b.detach())


def test_supervisor_gives_up():
    sup = Supervisor(max_restarts=2, backoff=0.0)
    calls = []

    def body(start):
        calls.append(start)
        raise RuntimeError("persistent failure")

    with pytest.raises(RuntimeError):
        sup.run(body, lambda: 0)
    assert len(calls) == 3  # initial + 2 restarts
    assert sup.restarts == 3


def test_watchdog_flags_straggler_on_an_injected_clock():
    now = [0.0]
    w = Watchdog(threshold=3.0, window=16, clock=lambda: now[0])
    for s in range(10):
        w.start()
        now[0] += 0.002
        assert w.stop(s) is False
    w.start()
    now[0] += 0.05
    assert w.stop(10) is True
    assert w.incidents == [(10, pytest.approx(0.05), pytest.approx(0.002))]
    w.start()
    now[0] += 0.005                 # within 3x the median
    assert w.stop(11) is False
    assert len(w.incidents) == 1
