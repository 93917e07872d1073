"""Tensor parallelism over 'model' for every block kind, against the JAX
package's ``make_sharded_train_step``.

The harness of ``test_torch_sharded_train.py`` (float32, ``reduced()``
widths, 2 layers, 4 rows of 16 tokens; the reference on as many forced
host devices as the mesh has, Auto-typed, in three subprocesses; the port
on gloo CPU ranks): two steps' loss, aux and ``grad_norm`` and step 0's
gradient, every leaf, within 2e-4.  The cases are the block kinds and
widths a 'model' split used to refuse:

* zamba2 on (1, 2) with ``use_sp`` and on (1, 4): ``mamba`` (the SSM
  heads split, two ranks sharing an SSM group on (1, 4)) and
  ``mamba_shared`` (its GQA block with 2 kv heads, below 'model' on
  (1, 4); its embedding stream cut under SP);
* deepseek-v2-lite on (1, 2) with ``use_sp`` (MLA without q-lora, its
  ``moe_dense`` prefix block on the whole stream, then ``moe`` on the
  chunks) and minicpm3 on (1, 2) (MLA with q-lora);
* whisper-tiny on (1, 2) with ``use_sp``: ``enc`` on the whole stream,
  ``dec`` on the chunks, with cross-attention;
* gemma3-1b on (1, 2): one kv head split over two ranks, qk-norm;
* mistral-large-123b on (1, 4): 2 kv heads on 4 ranks, with SP and FSDP;
* granite with ``use_sp`` on (1, 2) and (2, 2): sequence parallelism
  through ``moe`` blocks;
* zamba2 with ``d_model`` 96 and 3 SSM groups on (1, 4): 12 SSM heads,
  4 a group, 3 a rank, ranks 1 and 2 straddling two groups (ROADMAP
  A.9.11; reduced widths, as no public config straddles).

Two controls must fail the gate: zamba2 (1, 2) with the gated norm's sum
over 'model' dropped, and minicpm3 with MLA's entry into the model region
moved before ``w_dkv``.
"""
import contextlib
from unittest import mock

import numpy as np
import torch

import pytest
from test_torch_sharded_train import TOL, _config, _key, check_case, \
    run_cases

from repro_torch import tree
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import sharding as Sh

SP = {"use_sp": True}
CASES = (("zamba2-1.2b", (1, 2), SP), ("zamba2-1.2b", (1, 4)),
         ("deepseek-v2-lite-16b", (1, 2), SP), ("minicpm3-4b", (1, 2)),
         ("whisper-tiny", (1, 2), SP), ("gemma3-1b", (1, 2)),
         ("mistral-large-123b", (1, 4)),
         ("granite-moe-1b-a400m", (1, 2), SP),
         ("granite-moe-1b-a400m", (2, 2), SP),
         ("zamba2-1.2b", (1, 4), {"d_model": 96, "ssm_groups": 3}))


@contextlib.contextmanager
def _norm_sum_dropped():
    """The control's fault: the gated norm's sum of squares left to each
    rank's own heads."""
    with mock.patch.object(Sh, "sum_over_model", lambda x: x):
        yield


def _ckv(params, x, cfg, positions):
    """MLA's down-projection run inside the model region (its input
    entered there), so that ``w_dkv``'s and ``kv_norm``'s gradients are
    each rank's heads' alone."""
    dkv = L.linear(params["w_dkv"], Sh.enter_model(x))
    c_kv = L.norm_apply(params["kv_norm"], dkv[..., :cfg.kv_lora_rank])
    k_rope = L.rope_apply(dkv[..., cfg.kv_lora_rank:][:, :, None, :],
                          positions, cfg.rope_theta)[:, :, 0]
    return c_kv, k_rope


@contextlib.contextmanager
def _ckv_entered_early():
    """The control's fault: :func:`_ckv` in place of MLA's own."""
    with mock.patch.object(A, "_mla_ckv", _ckv):
        yield


CONTROLS = ((CASES.index(("zamba2-1.2b", (1, 2), SP)), _norm_sum_dropped),
            (CASES.index(("minicpm3-4b", (1, 2))), _ckv_entered_early))


@pytest.fixture(scope="module")
def runs():
    return run_cases(CASES, controls=CONTROLS)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_tp_step_matches_the_reference(runs, case):
    ref, port, _ = runs
    arch, shape = CASES[case][:2]
    check_case(ref[case], port[_key(CASES[case])], arch, shape)


def _failed_leaves(runs, control):
    """The leaves (by their path, norms by their module) whose step-0
    gradient misses the gate in control ``control``'s run."""
    ref, port, _ = runs
    case = CONTROLS[control][0]
    got = port[("control", case)]
    names = [p for p, _ in tree.paths(M.init(_config(CASES[case][0]), None,
                                             torch.device("meta")))]
    failed = set()
    for name, g, w in zip(names, got["grads"], ref[case]["grads"]):
        scale = float(np.abs(w).max())
        if float(np.abs(g - w).max()) > TOL * max(scale, 1e-30):
            failed.add("/".join(str(k) for k in name if k != "w"))
    return failed


def test_dropping_the_gated_norms_sum_fails_the_gate(runs):
    """zamba2 on (1, 2) (SP) with each rank normalising its heads by its own
    sum of squares: the mamba blocks' leaves miss the gate."""
    failed = _failed_leaves(runs, 0)
    assert any(f.endswith("mamba/gn") for f in failed), failed
    assert any(f.endswith("mamba/w_in") for f in failed), failed


def test_entering_mla_before_w_dkv_fails_the_gate(runs):
    """minicpm3 on (1, 2) with MLA's input entered into the model region
    before the down-projection: ``w_dkv`` and ``kv_norm`` get one rank's
    heads' gradient and miss the gate."""
    failed = _failed_leaves(runs, 1)
    assert any(f.endswith("attn/w_dkv") for f in failed), failed
    assert any(f.endswith("attn/kv_norm") for f in failed), failed
