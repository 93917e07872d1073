"""Attention heads split unevenly over 'model' (ROADMAP A.9.10), against
the JAX package's ``make_sharded_train_step``, whose GSPMD cuts them so.

The harness of ``test_torch_sharded_train.py`` (float32, ``reduced()``
widths, 2 layers, 4 rows of 16 tokens; the reference on as many forced
host devices as the mesh has, Auto-typed, in subprocesses; the port on
gloo CPU ranks): two steps' loss, aux and ``grad_norm`` and step 0's
gradient, every leaf, within 2e-4.  Every stored leaf's dims divide the
mesh, as the production cells' do; only the head counts do not.  Heads
go to ranks as ``sharding.chunk_range`` cuts an uneven dim: ceil-sized
chunks, the last ranks short or empty.

* gemma2-2b with 6 heads and 2 kv heads on (1, 4): heads 2 / 2 / 2 / 0,
  rank 1's two heads reading both kv heads, rank 3 none;
* whisper-tiny with 6 heads (and 6 kv heads) on (1, 4), with ``use_sp``:
  ``enc``, ``dec`` and the cross-attention;
* gemma3-1b (4 heads, 1 kv head) on (1, 8): MQA and qk-norm, with half
  the ranks empty;
* minicpm3-4b with 6 heads on (1, 4): MLA with q-lora;
* gemma3-1b with 12 heads over 6 kv heads on (1, 4): each rank's 3 heads
  straddle two kv heads, so each q head gets its own copy of the kv head
  it reads.

A control must fail the gate: ``model_range`` reverted to ``n // m``
heads a rank (the head count a rank's stored columns would give, the
last 2 of 6 heads dropped), in the GQA case.
"""
import contextlib
from unittest import mock

import pytest
from test_torch_sharded_train import _key, check_case, run_cases

from repro_torch.models import sharding as Sh

CASES = (("gemma2-2b", (1, 4), {"n_heads": 6, "n_kv_heads": 2}),
         ("whisper-tiny", (1, 4), {"n_heads": 6, "n_kv_heads": 6,
                                   "use_sp": True}),
         ("gemma3-1b", (1, 8), {}),
         ("minicpm3-4b", (1, 4), {"n_heads": 6}),
         ("gemma3-1b", (1, 4), {"n_heads": 12, "n_kv_heads": 6}))


def _even_range(n):
    """The control's ``model_range``: ``n // m`` heads a rank."""
    r, m = Sh.model_split()
    return r * (n // m), (r + 1) * (n // m)


@contextlib.contextmanager
def _even_heads():
    with mock.patch.object(Sh, "model_range", _even_range):
        yield


CONTROLS = ((0, _even_heads),)


@pytest.fixture(scope="module")
def runs():
    return run_cases(CASES, controls=CONTROLS)


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"{c[0]}-{c[1][0]}x{c[1][1]}" for c in CASES])
def test_uneven_heads_step_matches_the_reference(runs, case):
    ref, port, _ = runs
    arch, shape = CASES[case][:2]
    check_case(ref[case], port[_key(CASES[case])], arch, shape)


def test_even_heads_a_rank_fail_the_gate(runs):
    """The control: 1 of 6 heads a rank on (1, 4) computes 4 heads, and
    the loss misses the gate."""
    ref, port, _ = runs
    with pytest.raises(AssertionError):
        check_case(ref[0], port[("control", 0)], *CASES[0][:2])
