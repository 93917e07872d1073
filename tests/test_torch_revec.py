"""The port's re-vectorizer ``repro_torch.port.revec`` against the JAX
package's ``repro.port.revec``, on the 24-kernel corpus of
``examples/neon_corpus`` and on the hand-written strip shapes of
``tests/test_port_compile.py``:

* ``retile(fn, t).fn.pretty()`` and the decisions (``factor``,
  ``retiled``, ``masked``, ``strips``, ``narrow_fallbacks``, ``vetoes``)
  equal the reference's for every kernel over ``BENCH_port.json``'s sweep
  (rvv-64, rvv-64-m2, rvv-128 ... rvv-1024) and ``h100``, every tail
  policy and ``factor_cap`` in {None, 1, 2};
* ``strict=True`` raises ``RevecVeto`` where the reference does;
* ``h100`` is a fixed-tile machine: its factor is 1 and nothing widens,
  exactly as the reference re-tiles for its own fixed-tile machine
  (tpu-v5e), which stands in for h100 in the comparison.
"""
import json
import os

import numpy as np
import pytest

from repro import port as jport
from repro.port import revec as jrevec
from repro_torch import port
from repro_torch.core.targets import get_target
from repro_torch.port import revec

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CORPUS = os.path.join(ROOT, "examples", "neon_corpus")
SWEEP = json.loads(open(os.path.join(ROOT, "BENCH_port.json")).read())[
    "sweep"]
TARGETS = tuple(SWEEP) + ("h100",)
CAPS = (None, 1, 2)
KERNELS = sorted(n for n in port.load_corpus(CORPUS))


@pytest.fixture(scope="module")
def corpora():
    return jport.load_corpus(CORPUS), port.load_corpus(CORPUS)


def _ref_target(t):
    # the reference has no h100; its fixed-tile machine stands in
    return "tpu-v5e" if t == "h100" else t


def _named(text, t):
    """The reference's text with h100 in its stand-in's place."""
    return text.replace("tpu-v5e", "h100") if t == "h100" else text


def _decisions(res):
    return (res.factor, res.retiled, res.masked, res.strips,
            res.narrow_fallbacks, res.vetoes)


def test_tail_policies_are_the_reference_s():
    assert revec.TAIL_POLICIES == jrevec.TAIL_POLICIES
    assert len(revec.TAIL_POLICIES) == 3


@pytest.mark.parametrize("kernel", KERNELS)
def test_retile_is_the_reference_s(kernel, corpora):
    jk, tk = corpora
    for t in TARGETS:
        for tail in revec.TAIL_POLICIES:
            for cap in CAPS:
                want = jrevec.retile(jk[kernel].fn, _ref_target(t),
                                     factor_cap=cap, tail=tail)
                got = revec.retile(tk[kernel].fn, t, factor_cap=cap,
                                   tail=tail)
                label = f"{kernel}/{t}/{tail}/cap={cap}"
                assert got.fn.pretty() == want.fn.pretty(), label
                assert _decisions(got) == _decisions(want), label
                assert got.notes == [_named(n, t) for n in want.notes], \
                    label
                if t == "h100":
                    assert got.factor == 1 and got.retiled == 0, label
                    assert got.fn.pretty() == tk[kernel].pretty(), label


@pytest.mark.parametrize("kernel", KERNELS)
def test_strict_raises_where_the_reference_raises(kernel, corpora):
    jk, tk = corpora
    for t in ("rvv-128", "rvv-1024", "h100"):
        try:
            jrevec.retile(jk[kernel].fn, _ref_target(t), strict=True)
            want = None
        except jport.RevecVeto as e:
            want = e
        if want is None:
            revec.retile(tk[kernel].fn, t, strict=True)
            continue
        with pytest.raises(port.RevecVeto) as got:
            revec.retile(tk[kernel].fn, t, strict=True)
        assert str(got.value) == _named(str(want), t), f"{kernel}/{t}"


@pytest.mark.parametrize("kernel", KERNELS)
def test_strip_loops_and_loop_forms_are_the_reference_s(kernel, corpora):
    """What compile's trip counts read: the matched strips, and for every
    loop its affine steps and condition, by value-name."""
    jk, tk = corpora

    def loops(fn):
        out, todo = [], [fn.body]
        while todo:
            for ins in todo.pop().instrs:
                if type(ins).__name__ == "Loop":
                    out.append(ins)
                    todo.append(ins.body)
                elif type(ins).__name__ == "IfOp":
                    todo += [ins.then, ins.els]
        return out

    def form(loop, mod):
        steps = {p.hint: s for p, s in mod.loop_affine(loop).items()}
        cond = mod.loop_condition(loop)
        if cond is not None:
            phi, off, op, bound = cond
            cond = (phi.hint, off, op,
                    getattr(bound.root, "hint", None), bound.off)
        return steps, cond

    jl, tl = loops(jk[kernel].fn), loops(tk[kernel].fn)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert form(b, revec) == form(a, jrevec)
    js = jrevec.strip_loops(jk[kernel].fn)
    ts = revec.strip_loops(tk[kernel].fn)
    assert [(s.step, s.scalable, s.reasons, s.cond_ne) for s in ts] == \
        [(s.step, s.scalable, s.reasons, s.cond_ne) for s in js]


# the hand-written strip shapes of tests/test_port_compile.py
SOURCES = {
    "biased_dot": """
    void biased_dot(size_t n, const float* a, const float* b, float* s) {
      float32x4_t acc = vdupq_n_f32(1.0f);
      for (; n >= 4; n -= 4) {
        acc = vfmaq_f32(acc, vld1q_f32(a), vld1q_f32(b));
        a += 4; b += 4;
      }
      *s = vaddvq_f32(acc);
    }
    """,
    "add2x": """
    void add2x(size_t n, const float* a, const float* b, float* y) {
      for (; n >= 8; n -= 8) {
        float32x4_t x0 = vld1q_f32(a);
        float32x4_t x1 = vld1q_f32(a + 4); a += 8;
        float32x4_t y0 = vld1q_f32(b);
        float32x4_t y1 = vld1q_f32(b + 4); b += 8;
        vst1q_f32(y, vaddq_f32(x0, y0));
        vst1q_f32(y + 4, vaddq_f32(x1, y1)); y += 8;
      }
      for (; n != 0; n -= 1) {
        *y = *a + *b;
        a += 1; b += 1; y += 1;
      }
    }
    """,
    "addswap": """
    void addswap(size_t n, const float* a, const float* b, float* y) {
      for (; n >= 8; n -= 8) {
        float32x4_t x0 = vld1q_f32(a);
        float32x4_t x1 = vld1q_f32(a + 4); a += 8;
        float32x4_t y0 = vld1q_f32(b);
        float32x4_t y1 = vld1q_f32(b + 4); b += 8;
        vst1q_f32(y, vaddq_f32(x0, y1));
        vst1q_f32(y + 4, vaddq_f32(x1, y0)); y += 8;
      }
      for (; n != 0; n -= 1) {
        *y = *a + *b;
        a += 1; b += 1; y += 1;
      }
    }
    """,
    "dot2x": """
    void dot2x(size_t n, const float* a, float* s) {
      float32x4_t acc0 = vdupq_n_f32(0.0f);
      float32x4_t acc1 = vdupq_n_f32(0.0f);
      for (; n >= 8; n -= 8) {
        acc0 = vaddq_f32(acc0, vld1q_f32(a));
        acc1 = vaddq_f32(acc1, vld1q_f32(a + 4));
        a += 8;
      }
      float t = vaddvq_f32(acc0) + vaddvq_f32(acc1);
      for (; n != 0; n -= 1) {
        t = t + *a; a += 1;
      }
      *s = t;
    }
    """,
    "scale4": """
    void scale4(size_t n, const float* x, const float* s, float* y) {
      for (; n >= 4; n -= 4) {
        float32x4_t vs = vld1q_f32(s);
        vst1q_f32(y, vmulq_f32(vld1q_f32(x), vs));
        x += 4; y += 4;
      }
    }
    """,
    "coeff": """
    void coeff(size_t n, const float* x, const float* w, float* y) {
      for (; n >= 4; n -= 4) {
        float32x4_t vc = vdupq_n_f32(*w); w += 1;
        vst1q_f32(y, vmulq_f32(vld1q_f32(x), vc));
        x += 4; y += 4;
      }
    }
    """,
}


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_hand_written_strips_retile_as_the_reference(name):
    jk = jport.compile_kernel(SOURCES[name])
    tk = port.compile_kernel(SOURCES[name])
    for t in ("rvv-128", "rvv-256", "rvv-1024", "rvv-256-m4"):
        want, got = jk.retile(t), tk.retile(t)
        assert got.fn.pretty() == want.fn.pretty(), f"{name}/{t}"
        assert _decisions(got) == _decisions(want), f"{name}/{t}"
        assert got.notes == want.notes, f"{name}/{t}"


def test_retile_factors_track_effective_width():
    k = port.compile_file(os.path.join(CORPUS, "vadd.c"))
    for target, factor in (("rvv-64", 1), ("rvv-128", 1), ("rvv-256", 2),
                           ("rvv-512", 4), ("rvv-1024", 8),
                           ("rvv-256-m4", 8), ("rvv-1024-m8", 64),
                           ("h100", 1)):
        assert k.retile(target).factor == factor, target
    assert get_target("h100").retile_factor(4, np.float32) == 1
    assert get_target("h100").effective_vlen == 0


def test_the_retile_seam_fires_in_the_port():
    from repro_torch.port import faultinject, resilience
    k = port.compile_file(os.path.join(CORPUS, "vadd.c"))
    with faultinject.injected("revec.retile",
                              error=resilience.RevecVeto) as plan:
        with pytest.raises(port.RevecVeto):
            k.retile("rvv-1024")
    assert plan.fired == 1
    assert k.retile("rvv-1024").factor == 8
