"""Sequence parallelism, and tensor parallelism on an FSDP config.

mistral-large-123b is ``use_sp=True, fsdp=True``: on a 'model' axis
above 1 its residual stream is cut over the sequence
(``sharding.constrain``), the blocks' column-parallel inputs gather it,
``linear_rp`` reduce-scatters back into it, and each layer's FSDP shard
is gathered to its TP-only shard first.  Held here:

* the sharded step of mistral ``reduced()`` float32 (2 layers) on
  (2, 2) (FSDP, data, tensor and sequence parallelism at once) and on
  (1, 2), and of pixtral with ``use_sp`` on (1, 2) (the stream cut
  across its patch prefix and its tokens), against the reference's
  ``make_sharded_train_step`` on as many forced host devices (the
  harness of ``test_torch_sharded_train.py``): two steps' metrics and
  step 0's gradient leaf by leaf within 2e-4;
* the stream's cut and gather, and the reduce-scatter, as identities on
  2 and 4 gloo ranks, forward and backward;
* ``check_mesh`` refusing, by name (A.9.10), the uneven splits that
  stay refused once A.9.8's kinds are lifted.
"""
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch import mesh as LM
from repro_torch.models import sharding as Sh

from test_torch_sharded_train import _key, check_case, run_cases

# mistral's own SP; pixtral with SP on: its 4 patches before 16 tokens cut
# over 'model' with them, and dropped after the stream is gathered
CASES = (("mistral-large-123b", (2, 2)), ("mistral-large-123b", (1, 2)),
         ("pixtral-12b", (1, 2), {"use_sp": True}))


@pytest.fixture(scope="module")
def runs():
    return run_cases(CASES)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_sp_fsdp_tp_step_matches_the_reference(runs, case):
    ref, port, _ = runs
    arch, shape, *_ = CASES[case]
    check_case(ref[case], port[_key(CASES[case])], arch, shape)


def _stream(rank, world, shape, seq):
    """On mesh ``shape``: the cut of a (2, seq, 4) stream gathered back,
    its gradient, and the partial sums reduce-scattered and gathered
    against their all-reduce; every rank's view."""
    torch.set_num_threads(1)
    mesh = LM.make_mesh(shape, ("data", "model"), "cpu")
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, seq, 4, generator=gen, dtype=torch.float64)
    w = torch.randn(2, seq, 4, generator=gen, dtype=torch.float64)
    part = torch.randn(2, seq, 4, generator=gen, dtype=torch.float64) + \
        mesh.coordinate()["model"]
    with Sh.active_mesh(mesh):
        xr = x.clone().requires_grad_(True)
        chunk = Sh.constrain(xr, "batch", "model", None)
        cut_len = chunk.shape[1]
        again = Sh.constrain(chunk, "batch", "model", None)
        whole = Sh.gather_stream(again)
        (whole * w).sum().backward()
        after = Sh.current_state()[2]
        # a second cut, then the row-parallel sum into it and out again
        Sh.constrain(x, "batch", "model", None)
        scattered = Sh.leave_model(part.clone())
        gathered = Sh.enter_model(scattered)
        Sh.gather_stream(scattered)
    total = Sh.all_reduce(part.clone(), mesh, ("model",))
    return {"same": torch.equal(whole, x), "grad": torch.equal(xr.grad, w),
            "kept": again is chunk, "cut": cut_len,
            "whole_after": after is None,
            "reduce_scatter": torch.equal(gathered, total)}


@pytest.mark.parametrize("shape", [(1, 2), (1, 4), (2, 2)])
def test_stream_cut_and_gather_are_identities(shape):
    """The cut then the gather give the stream back bitwise, backward
    too; a second constraint keeps the cut stream; the reduce-scatter
    gathered is the all-reduce; uneven chunks (9 over 2 or 4)."""
    world = shape[0] * shape[1]
    rows = LM.run_ranks(_stream, world, shape, 9, timeout=60)
    for r in rows:
        assert r["same"] and r["grad"] and r["kept"], r
        assert r["whole_after"] and r["reduce_scatter"], r
    assert sum(r["cut"] for r in rows) == 9 * shape[0]
    assert max(r["cut"] for r in rows) == -(-9 // shape[1])


def test_a98_refusals_still_name_their_item():
    """Of A.9.8's refusals, lifted with its port, what stays refused names
    its item, A.9.11, closed, and why the JAX package refuses it too: a
    'model' axis that does not divide the FFN columns or the experts
    (attention heads split unevenly since A.9.10).
    The kinds A.9.8 refused (other block kinds, MLA, kv heads below
    'model', sequence parallelism through moe blocks) now pass."""
    tp = Sh.Mesh((2, 2), ("data", "model"))
    for arch in ("zamba2-1.2b", "deepseek-v2-lite-16b", "minicpm3-4b",
                 "whisper-tiny", "gemma3-1b"):
        Sh.check_mesh(get_config(arch), tp)
    Sh.check_mesh(get_config("granite-moe-1b-a400m").replace(use_sp=True),
                  tp)
    with pytest.raises(NotImplementedError,
                       match=r"d_ff 28672 \(its jit needs the FFN's wg / "
                             r"wu / wd cut.*refuses the same mesh "
                             r"\(ROADMAP A.9.11, closed\)"):
        Sh.check_mesh(get_config("mistral-large-123b"),
                      Sh.Mesh((1, 3), ("data", "model")))
    with pytest.raises(NotImplementedError,
                       match=r"n_experts 32 \(its moe shard_map splits "
                             r"the expert stacks.*refuses the same mesh "
                             r"\(ROADMAP A.9.11, closed\)"):
        Sh.check_mesh(get_config("granite-moe-1b-a400m").replace(
            use_sp=True), Sh.Mesh((2, 3), ("data", "model")))
    # what A.9.7 lifts: SP and FSDP on a 'model' axis of 2 and 8, and 16
    # (8 kv heads, 6 q heads a rank reading one of them)
    for m in (2, 8, 16):
        Sh.check_mesh(get_config("mistral-large-123b"),
                      Sh.Mesh((2, m), ("data", "model")))
