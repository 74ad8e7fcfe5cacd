"""The port's measurement kernels (``stereovision_tpu_torch.ops.bench_cuda``)
and scripts (``stereovision_tpu_torch.scripts``) against the JAX package's
TPU measurement scripts, on the CPU.

Each script under ``scripts/`` is loaded by path, its module constants are
shrunk with ``monkeypatch`` (the files are not edited), and its Pallas
kernel runs in interpret mode: ``build(variant)`` under
``force_tpu_interpret_mode()`` with K=1, or ``make_pallas``/``make_shear``
with ``interpret=True``. Every ``pallas_call`` output is captured through
a debug callback, so both directions and every map are compared, not only
what the script's timing loop returns. The same numpy inputs go through
the port's plain version of the same variant (in the port's layout: lane
groups of 32 planes become lines or pixels of their own, the (W, H, D)
transposes (H, W, D)), and the two must agree at atol 0, the deliberately
wrong variants included.
"""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from stereovision_tpu_torch.ops import bench_cuda, sgm_cuda
from stereovision_tpu_torch.scripts import (bench_agg_step, bench_rdisp, bench_sumwta,
                                            bench_wta_variants)

REPO = Path(__file__).resolve().parents[1]
RNG = np.random.default_rng(41)


def _load(name):
    spec = importlib.util.spec_from_file_location(f"tpu_scripts_{name}",
                                                  REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run_captured(fn, *args, consts, module):
    """Call ``fn(*args)`` (a jitted script function) with ``module``'s
    constants set to ``consts``, in TPU interpret mode, and return the
    outputs of its last ``pallas_call`` as numpy arrays."""
    outs = []
    orig = pl.pallas_call

    def pallas_call(*a, **k):
        call = orig(*a, **k)

        def run(*xs):
            res = call(*xs)
            jax.debug.callback(lambda r: outs.append(jax.tree_util.tree_map(np.asarray, r)), res)
            return res
        return run

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", pallas_call)
        for name, value in consts.items():
            mp.setattr(module, name, value)
        with pltpu.force_tpu_interpret_mode():
            jax.block_until_ready(fn()(*args))
    jax.effects_barrier()
    out = outs[-1]
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


# ---------------------------------------------------------------------------
# bench_agg_step: aggregate_dual's recurrence
# ---------------------------------------------------------------------------

AGG_W, AGG_X, AGG_D, AGG_BS = 8, 8, 128, 4
# costs up to 60 with P2 = 96 reach the int8 store's clamp at 127
AGG_COST = RNG.integers(0, 61, size=(AGG_W, AGG_X, AGG_D)).astype(np.int8)


def _interleave(a):
    """lane g·32 + d → lane d·4 + g (the script's stride-4 group layout)."""
    return a.reshape(*a.shape[:-1], 4, 32).swapaxes(-1, -2).reshape(a.shape)


def _deinterleave(a):
    return a.reshape(*a.shape[:-1], 32, 4).swapaxes(-1, -2).reshape(a.shape)


@functools.lru_cache(maxsize=None)
def _agg_reference(variant, interleaved=False):
    """The script's outputs for ``variant`` on AGG_COST (interleaved: on its
    lane-interleaved copy, de-interleaved back)."""
    mod = _load("bench_agg_step")
    cost = _interleave(AGG_COST) if interleaved else AGG_COST
    arg = jnp.asarray(cost.astype(np.float32) if variant == "f32in" else cost)
    outs = _run_captured(lambda: mod.build(variant), arg, module=mod,
                         consts=dict(W=AGG_W, X=AGG_X, D=AGG_D, BS=AGG_BS, K=1))
    return tuple(_deinterleave(o) if interleaved else o for o in outs)


def _agg_port(monkeypatch, variant):
    """The port's plain version of ``variant`` on AGG_COST, through the
    port script's view, as (W, X, 128) arrays."""
    for name, value in dict(W=AGG_W, X=AGG_X, D=AGG_D, BS=AGG_BS).items():
        monkeypatch.setattr(bench_agg_step, name, value)
    x = bench_agg_step.variant_input(torch.from_numpy(AGG_COST), variant)
    outs = bench_cuda.aggregate_dual_variants(x, variant, bench_agg_step.P1, bench_agg_step.P2,
                                              AGG_BS)
    assert all(o.dtype == torch.int8 for o in outs)
    return tuple(o.reshape(o.shape[0], AGG_X, AGG_D).numpy() for o in outs)


# port variant → the script's variant computing the same function; the port's
# shipping kernel and its other block sizes compute the script's full_raw
AGG_CASES = {v: v for v in ("full_raw", "full_norm", "no_groupmin", "no_shifts", "fwd_only",
                            "g1_raw", "copy", "copy1", "bs2", "f32in")}
AGG_CASES.update({"shipping": "full_raw", "bs1": "full_raw", "bs8": "full_raw",
                  "bs16": "full_raw"})


@pytest.mark.parametrize("variant", sorted(AGG_CASES))
def test_aggregate_variant_matches_the_script(monkeypatch, variant):
    ref = _agg_reference(AGG_CASES[variant])
    got = _agg_port(monkeypatch, variant)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


def test_aggregate_variants_reach_the_int8_clamp_and_differ(monkeypatch):
    """The inputs reach the clamp, and the wrong variants are other
    functions than the shipping kernel's."""
    ship = _agg_port(monkeypatch, "shipping")
    assert ship[0].max() == 127
    for v in ("full_norm", "no_groupmin", "no_shifts"):
        assert not np.array_equal(_agg_port(monkeypatch, v)[0], ship[0]), v


def test_aggregate_no_store_matches_the_script_at_its_rows(monkeypatch):
    """The script writes only row j·bs of each block (its last L forward,
    its own backward); the port's compact volume holds those rows."""
    ref = _agg_reference("no_store")
    got = _agg_port(monkeypatch, "no_store")
    assert got[0].shape[0] == AGG_W // AGG_BS
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r[::AGG_BS])


def test_gm_interleave5_matches_full_raw_and_the_interleaved_script(monkeypatch):
    """The script's gm_interleave5 is correct on the lane-interleaved
    layout: fed the interleaved copy and de-interleaved, it equals its
    full_raw, and so does the port's gm_interleave5 (4 lines a warp)."""
    got = _agg_port(monkeypatch, "gm_interleave5")
    for g, a, b in zip(got, _agg_reference("gm_interleave5", interleaved=True),
                       _agg_reference("full_raw")):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(g, b)


def test_aggregate_variants_refuse_what_they_do_not_run():
    cost = torch.zeros((4, 5, 32), dtype=torch.int8)
    with pytest.raises(ValueError, match="unknown"):
        bench_cuda.aggregate_dual_variants(cost, "gm_slice")
    with pytest.raises(ValueError, match="bs"):
        bench_cuda.aggregate_dual_variants(cost, "no_store", bs=0)


# ---------------------------------------------------------------------------
# bench_wta_variants: wta_stats_from_duals
# ---------------------------------------------------------------------------

WTA_W, WTA_HS, WTA_D, WTA_G = 32, 128, 128, 4
WTA_HF = RNG.integers(0, 100, size=(WTA_W, WTA_HS, WTA_D)).astype(np.int8)
WTA_HB = RNG.integers(0, 100, size=(WTA_W, WTA_HS, WTA_D)).astype(np.int8)


@functools.lru_cache(maxsize=None)
def _wta_reference(variant):
    """The script's maps for ``variant``, unpacked to [stat][w, h, g] with
    stats (best, idx, cm, cp, comp)."""
    mod = _load("bench_wta_variants")
    outs = _run_captured(lambda: mod.build(variant), jnp.asarray(WTA_HF), jnp.asarray(WTA_HB),
                         module=mod, consts=dict(W=WTA_W, Hs=WTA_HS, K=1))
    G, bh = WTA_G, 128
    if variant == "unpacked":  # orefs[g·5 + k]: k = best, cm, cp, comp, idx
        per = [np.stack([outs[g * 5 + k][:WTA_W, :WTA_HS] for g in range(G)], -1)
               for k in range(5)]
        best, cm, cp, comp, idx = per
    else:  # stats[w, (k·G + g)·bh + b], idx[w, g·bh + b] (one block of bh rows)
        stats = outs[0][:WTA_W].reshape(WTA_W, 4, G, bh)[..., :WTA_HS].transpose(1, 0, 3, 2)
        best, cm, cp, comp = stats
        idx = outs[1][:WTA_W].reshape(WTA_W, G, bh)[..., :WTA_HS].transpose(0, 2, 1)
    return best, idx, cm, cp, comp


WTA_CASES = {v: v for v in ("base", "f32sum", "bestonly", "nokey", "unpacked", "sumonly")}
WTA_CASES.update({"smallblk": "base", "bigblk": "base"})  # block sizes: the same function


@pytest.mark.parametrize("variant", sorted(WTA_CASES))
def test_wta_stats_variant_matches_the_script(variant):
    hf, hb = (torch.from_numpy(a).view(WTA_W, WTA_HS * WTA_G, WTA_D // WTA_G)
              for a in (WTA_HF, WTA_HB))
    got = bench_cuda.wta_stats_variants(hf, hb, variant)
    ref = _wta_reference(WTA_CASES[variant])
    assert len(got) == (2 if variant in ("bestonly", "sumonly") else 5)
    for g, r in zip(got, ref):
        g = g.view(WTA_W, WTA_HS, WTA_G).numpy()
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)
    if variant == "f32sum":  # the float sentinel reached cm or cp at the plane edges
        assert (got[2].numpy() == 1e9).any() or (got[3].numpy() == 1e9).any()


# ---------------------------------------------------------------------------
# bench_rdisp: the log-shear right_disparity
# ---------------------------------------------------------------------------


RDISP_S = RNG.integers(0, 480, size=(8, 256, 128)).astype(np.int16)


@functools.lru_cache(maxsize=None)
def _rdisp_reference():
    mod = _load("bench_rdisp")
    return np.asarray(mod.make_shear(128, interpret=True)(jnp.asarray(RDISP_S)))


@pytest.mark.parametrize("variant", sorted(bench_cuda.RDISP_VARIANTS))
def test_right_disparity_variant_matches_the_shear(variant):
    arg = torch.from_numpy(RDISP_S)
    if variant == "transposed":
        arg = arg.permute(2, 0, 1).contiguous()
    got = bench_cuda.right_disparity_variants(arg, variant)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _rdisp_reference())


# ---------------------------------------------------------------------------
# bench_sumwta: the fused sum + WTA
# ---------------------------------------------------------------------------

SUM_H, SUM_W, SUM_D, SUM_DV = 8, 128, 128, 96


def _sum_inputs():
    rng = np.random.default_rng(7)
    hf_t, hb_t = (rng.integers(0, 120, size=(SUM_W, SUM_H, SUM_D)).astype(np.int8)
                  for _ in range(2))
    vf, vb = (rng.integers(0, 120, size=(SUM_H, SUM_W, SUM_D)).astype(np.int8) for _ in range(2))
    # a few pixels win at the last valid plane, so cp meets a masked plane
    hf_t[:5, :, SUM_DV - 1] = hb_t[:5, :, SUM_DV - 1] = 0
    vf[:, :5, SUM_DV - 1] = vb[:, :5, SUM_DV - 1] = 0
    return hf_t, hb_t, vf, vb


@pytest.mark.parametrize("emit", sorted(sgm_cuda.SUM_EMITS))
def test_sum_wta_matches_the_fused_script_kernel(emit):
    hf_t, hb_t, vf, vb = _sum_inputs()
    mod = _load("bench_sumwta")
    ref = mod.make_pallas(SUM_DV, emit=emit, block_h=8, block_w=128, interpret=True)(
        *(jnp.asarray(a) for a in (hf_t, hb_t, vf, vb)))
    got = bench_cuda.sum_wta(*(torch.from_numpy(a) for a in (hf_t.transpose(1, 0, 2).copy(),
                                                             hb_t.transpose(1, 0, 2).copy(),
                                                             vf, vb)),
                             d_valid=SUM_DV, emit=emit)
    if emit == "none":
        assert got[0] is None
    got = [g for g in got if g is not None]
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.numpy().dtype == np.asarray(r).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert (got[-4].numpy() == SUM_DV - 1).any()  # idx at the last valid plane
    assert (got[-2].numpy() == 2.0 ** 21).any()  # cp = a masked plane there


def test_sum_wta_yardsticks_agree_with_the_kernel_where_all_planes_are_valid():
    """At d_valid = D the engine's plain sum_wta (``cur``) and the (D, H, W)
    formulation (``st_first``) compute the fused kernel's function."""
    vols = [torch.from_numpy(RNG.integers(0, 120, size=(6, 20, 40)).astype(np.int8))
            for _ in range(4)]
    hwd = bench_cuda.sum_wta(*vols, emit="hwd")
    for a, b in zip(sgm_cuda.sum_wta(vols, emit_sum=True), hwd):
        assert torch.equal(a, b)
    for a, b in zip(bench_sumwta.st_first(*vols, 40), bench_cuda.sum_wta(*vols, emit="dhw")):
        assert torch.equal(a, b)


def test_sum_wta_refuses_bad_arguments():
    v = torch.zeros((2, 3, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="emit"):
        bench_cuda.sum_wta(v, v, v, v, emit="whd")
    with pytest.raises(ValueError, match="d_valid"):
        bench_cuda.sum_wta(v, v, v, v, d_valid=9)
    with pytest.raises(ValueError, match="shapes"):
        bench_cuda.sum_wta(v, v, v, v[:1])


# ---------------------------------------------------------------------------
# The port's scripts, end to end on the CPU (plain versions, no timing)
# ---------------------------------------------------------------------------


def test_scripts_run_every_variant_on_the_cpu(monkeypatch):
    for mod, consts in ((bench_agg_step, dict(W=8, X=4)), (bench_wta_variants, dict(W=8, Hs=4)),
                        (bench_rdisp, dict(H=3, W=40)), (bench_sumwta, dict(H=3, W=20))):
        for name, value in consts.items():
            monkeypatch.setattr(mod, name, value)
    sgm_cuda.reset_launch_counts()
    rows = (bench_agg_step.run(device="cpu") + bench_wta_variants.run(device="cpu")
            + bench_rdisp.run(ds=(16, 40), device="cpu")
            + bench_sumwta.run(ds=(32, 384), device="cpu"))
    assert [r["variant"] for r in rows[:len(bench_agg_step.VARIANTS)]] == list(
        bench_agg_step.VARIANTS)
    assert len(rows) == (len(bench_agg_step.VARIANTS) + len(bench_wta_variants.VARIANTS)
                         + 2 * len(bench_rdisp.VARIANTS) + 2 * len(bench_sumwta.VARIANTS))
    assert all(r["ms"] is None and r["device_ms"] is None and r["launches"] == 0 for r in rows)
    # every kernel row was held against its plain version; at D = 384 the
    # yardsticks (d_valid 320) have nothing to be held against
    unchecked = [r["variant"] for r in rows if r["max_abs_err"] is None]
    assert unchecked == ["cur D=384", "cur_nolr D=384", "st_first D=384"]
    assert set(sgm_cuda.launch_counts().values()) == {0}


def test_scripts_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for run in (bench_agg_step.run, bench_wta_variants.run, bench_rdisp.run, bench_sumwta.run):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run()
