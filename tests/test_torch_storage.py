"""bf16 deviation storage of the cylinder channel in the PyTorch port, on
the CPU, where each kernel wrapper of `kernels/cylinder.py` runs its
plain twin: the storage conversion against `ops/pallas/fused_step.py`'s,
the round-to-nearest twins against the Pallas fused step in TPU interpret
mode (as `tests/test_torch_cylinder.py` runs it) and against jnp steps,
Philox (`kernels/philox.py`) against Random123's known answers, the
stochastic-rounding store against `tests/test_sr_storage.py::sr_numpy`
fed the same bits, its statistics, the launch keys, and the shedding
entry point (`shedding.py`) against the validation scripts. The kernels
against these twins, bit for bit, are in `test_torch_cuda.py`.

Tolerances. The interpreted Pallas float32 step and the twin's differ by
one float32 rounding in about half the populations (at most ~6e-8; the
twin rounds as the CUDA kernel does), and a bf16 store rounds the two to
different patterns where they straddle a rounding boundary, which for a
small deviation g can be several bf16 ulps apart. So the stored patterns
are held to: equal wherever the two float32 steps agree bit for bit;
elsewhere no further apart than the float32 values plus one bf16 ulp;
at least 95% equal over the grid (measured 98.8% for the generic step,
98.6% for the split step, 96.2% after a k=2 pass). rho and vel within
1e-5 where a kernel writes them from the loaded f (k=1); where the
refresh takes them from the stored f (k-step passes), within 1e-5 plus
what the stored patterns' differences can move them: the sum over q of
|g_twin - g_ref| for rho, twice that for vel (|u| < 0.5, rho ~ 1).
Against jnp steps the float32 trajectory tolerance of
`test_torch_cylinder.py` plus one bf16 ulp for f.
"""

import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (this worker's share of the cores)

from jrl_lbm_tpu.models import cylinder as J
from jrl_lbm_tpu.ops.pallas import fused_step as JF
from jrl_lbm_torch import shedding as S
from jrl_lbm_torch.kernels import cylinder as K
from jrl_lbm_torch.kernels import philox as P
from jrl_lbm_torch.models import cylinder as T
from test_sr_storage import sr_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GENERIC = dict(res=(64, 32), D=8.0, Re=500.0, cylinder_center=(16.0, 32.0))
SPLIT = dict(res=(96, 32), D=8.0, Re=500.0, cylinder_center=(16.0, 48.0))
WQ = np.asarray([4 / 9] + [1 / 9] * 4 + [1 / 36] * 4, np.float32)[:, None, None]
MASK32 = 0xFFFFFFFF


def _interpret():
    from jax.experimental.pallas import tpu as pltpu

    return pltpu.force_tpu_interpret_mode()


def _bits(g):
    """int32 bf16 patterns of a bfloat16 tensor or array."""
    if isinstance(g, torch.Tensor):
        return g.view(torch.int16).numpy().astype(np.int32)
    return np.asarray(g).view(np.int16).astype(np.int32)


def _bf16_value(bits):
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _ulp(v):
    """One bf16 ulp at |v| (float32 array)."""
    e = np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** -126)))
    return np.exp2(e - 7).astype(np.float32)


def _scene(kw, steps=30):
    """JAX and port configs and fields, and one state developed by
    ``steps`` plain port steps and nudged by seeded noise, as numpy arrays
    (the same input for both packages)."""
    jc, tc = J.CylinderConfig(**kw), T.CylinderConfig(**kw)
    _, jf = J.init(jc)
    ts, tf = T.init(tc, "cpu")
    ts = T.make_runner(tc)(ts, tf, steps)
    rng = np.random.default_rng(7)
    s = {k: v.numpy() + (1e-4 * rng.standard_normal(tuple(v.shape))).astype(np.float32)
         for k, v in ts.items()}
    return jc, tc, s, jf, tf


def _held(tag, twin_g, pallas_g, twin_f32, pallas_f32):
    """The stored-pattern criteria of the module note."""
    a, b = _bits(twin_g), _bits(pallas_g)
    same_f32 = np.asarray(twin_f32).view(np.uint32) == np.asarray(pallas_f32).view(np.uint32)
    assert np.array_equal(a[same_f32], b[same_f32]), f"{tag}: patterns differ where f32 agrees"
    va, vb = _bf16_value(a), _bf16_value(b)
    gap = np.abs(np.asarray(twin_f32, np.float64) - np.asarray(pallas_f32, np.float64))
    bound = gap + _ulp(np.maximum(np.abs(va), np.abs(vb)))
    assert np.all(np.abs(va.astype(np.float64) - vb) <= bound), f"{tag}: patterns too far apart"
    frac = float((a == b).mean())
    assert frac >= 0.95, f"{tag}: {frac:.4%} of the stored patterns equal"


def _moments_held(tag, got, want, g_got, g_want, refreshed, mask=None):
    """rho and vel to 1e-5, plus the stored patterns' differences where
    the refresh took the moments from the stored f."""
    dg = np.abs(_bf16_value(_bits(g_got)).astype(np.float64) - _bf16_value(_bits(g_want)))
    slack = dg.sum(axis=0) if refreshed else 0.0
    for k, scale in (("rho", 1.0), ("vel", 2.0)):
        err = np.abs(np.asarray(got[k], np.float64) - np.asarray(want[k], np.float64))
        ok = err <= 1e-5 + scale * slack
        if mask is not None:
            ok = ok | ~np.broadcast_to(mask, ok.shape)
        assert ok.all(), f"{tag} {k}: {err[~ok].max():.3e}"


# --- Philox ---

@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((MASK32,) * 4, (MASK32,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(ctr, key, want):
    """Random123's known-answer vectors of Philox4x32-10."""
    assert tuple(int(w) for w in P.philox4x32(ctr, key)) == want


def test_philox_limb_product_is_exact():
    """The 16-bit-limb multiply equals the exact 64-bit product."""
    rng = np.random.default_rng(0)
    xs = np.concatenate([rng.integers(0, 2 ** 32, 2000), [0, 1, 0xFFFF, 0x10000, MASK32]])
    for m in (P.M0, P.M1, MASK32):
        hi, lo = P._mulhilo(m, torch.as_tensor(xs, dtype=torch.int64))
        want = [m * int(x) for x in xs]
        assert hi.tolist() == [w >> 32 for w in want]
        assert lo.tolist() == [w & MASK32 for w in want]


def test_sr_bits_counter_layout():
    """Population 2i takes the low and 2i+1 the high half of word i of
    counter (c, 0, 0, 0); population 8 the low half of word 0 of (c, 1)."""
    key = (12345, 67)
    r = P.sr_bits(50, key)
    for c in (0, 7, 49):
        w = [int(x) for x in P.philox4x32((c, 0, 0, 0), key)]
        w8 = int(P.philox4x32((c, 1, 0, 0), key)[0])
        want = [w[i // 2] >> (16 * (i % 2)) & 0xFFFF for i in range(8)] + [w8 & 0xFFFF]
        assert r[:, c].tolist() == want


# --- the storage conversion ---

@pytest.mark.parametrize("mode", [True, "sr"])
def test_storage_conversion_matches_jax(mode):
    """f_to_storage (round to nearest, also for "sr") and f_from_storage
    equal the JAX package's bit for bit."""
    rng = np.random.default_rng(1)
    f = (WQ + 0.03 * rng.standard_normal((9, 24, 16))).astype(np.float32)
    f[0, 0, :4] = WQ[0, 0, 0]  # zero deviations
    g = K.f_to_storage(torch.as_tensor(f), mode)
    jg = JF.f_to_storage(jnp.asarray(f), mode)
    assert g.dtype == torch.bfloat16 and g.shape == f.shape
    assert np.array_equal(_bits(g), _bits(jg))
    back = K.f_from_storage(g, mode).numpy()
    assert np.array_equal(back.view(np.uint32),
                          np.asarray(JF.f_from_storage(jg, mode)).view(np.uint32))
    assert K.f_to_storage(torch.as_tensor(f), False) is not None


# --- the round-to-nearest twins against the Pallas step ---

def _pallas_pair(jc, s, jf, make):
    """The Pallas step of ``make(bf16_dev)`` from the stored state (bf16)
    and from its float32 load: ``(bf16 out, f32 out)`` as numpy."""
    g = JF.f_to_storage(jnp.asarray(s["f"]), True)
    loaded = np.asarray(JF.f_from_storage(g, True))
    out = []
    for mode, f in ((True, g), (False, jnp.asarray(loaded))):
        state = {k: jnp.asarray(v) for k, v in s.items()}  # new buffers: the k=2 step donates
        with _interpret():
            o = make(mode)(dict(state, f=f), jf)
            out.append({k: np.asarray(v) for k, v in o.items()})
    return out


def _twin_pair(s, tf, make):
    ts = T.state_from_numpy(s, "cpu")
    g = K.f_to_storage(ts["f"], True)
    return make(True)(dict(ts, f=g), tf), make(False)(dict(ts, f=K.f_from_storage(g, True)), tf)


@pytest.mark.parametrize("path", ["generic", "split k=1", "k=2"])
def test_rn_twins_match_pallas(path):
    """One generic step (every row through cyl_full), one k=1 split step
    (cyl_interior + cyl_full) and one k=2 pass (cyl_interior_k, cyl_band_k
    "cyl" and "edge", then the refresh), from the same stored state."""
    kw = GENERIC if path == "generic" else SPLIT
    jc, tc, s, jf, tf = _scene(kw)
    if path == "k=2":
        def jmake(mode):
            st2 = JF.make_fused_step2(jc, tile_rows=8, k=2, bf16_dev=mode)
            return lambda st, fl: JF.make_macro_refresh(jc, bf16_dev=mode)(st2(st, fl), fl)

        def tmake(mode):
            st2 = K.make_fused_step2(tc, tile_rows=8, k=2, bf16_dev=mode)
            return lambda st, fl: K.make_macro_refresh(tc, bf16_dev=mode)(st2(st, fl), fl)
    else:
        kwargs = dict(tile_rows=8, split=path != "generic", interior_rows=16)

        def jmake(mode):
            return JF.make_fused_step(jc, bf16_dev=mode, **kwargs)

        def tmake(mode):
            return K.make_fused_step(tc, bf16_dev=mode, **kwargs)
    p16, p32 = _pallas_pair(jc, s, jf, jmake)
    t16, t32 = _twin_pair(s, tf, tmake)
    assert t16["f"].dtype == torch.bfloat16
    _held(path, t16["f"], p16["f"], t32["f"].numpy() - WQ, p32["f"] - WQ)
    _moments_held(path, {k: t16[k].numpy() for k in ("rho", "vel")}, p16, t16["f"], p16["f"],
                  refreshed=path == "k=2")


def test_rn_k4_twin_matches_jnp():
    """One k=4 pass of the round-to-nearest twins (one load, four float32
    steps, one store) against four jnp steps between one
    f_from_storage and one f_to_storage, non-OBSTACLE cells; rho and vel
    of both from the stored f (the refresh), to the trajectory tolerances
    (2e-5, vel 2e-4) plus what the patterns' differences move them (the
    sum over q of |g_twin - g_jnp|, ten times that for vel)."""
    jc, tc, s, jf, tf = _scene(SPLIT)
    ts = T.state_from_numpy(s, "cpu")
    g = K.f_to_storage(ts["f"], True)
    js = {k: jnp.asarray(v) for k, v in s.items()}
    js = dict(js, f=JF.f_from_storage(JF.f_to_storage(js["f"], True), True))
    want = J.make_runner(jc)(js, jf, 4)
    want = T.state_from_numpy({k: np.asarray(v) for k, v in want.items()}, "cpu")
    refresh = K.make_macro_refresh(tc, bf16_dev=True)
    want = refresh(dict(want, f=K.f_to_storage(want["f"], True)), tf)  # moments of stored f
    step4 = K.make_fused_step2(tc, tile_rows=8, k=4, bf16_dev=True)
    got = refresh(step4(dict(ts, f=g), tf), tf)
    fluid = tf["flags"].numpy() != int(K.OBSTACLE)
    va, vb = _bf16_value(_bits(got["f"])), _bf16_value(_bits(want["f"]))
    bound = 2e-5 * (1 + np.abs(vb + WQ)) + _ulp(np.maximum(np.abs(va), np.abs(vb)))
    m = np.broadcast_to(fluid, va.shape)
    assert np.all(np.abs(va - vb)[m] <= bound[m])
    slack = 2e-5 + np.abs(va.astype(np.float64) - vb).sum(axis=0)
    for k, scale in (("rho", 1.0), ("vel", 10.0)):
        err = np.abs(got[k].numpy().astype(np.float64) - want[k].numpy())
        assert np.all((err <= scale * slack)[..., fluid]), k


# --- stochastic rounding ---

@pytest.mark.parametrize("key", [(0, 0), (2 ** 32 - 1, 12345)])
def test_sr_store_matches_sr_numpy(key):
    """The stochastic-rounding store equals the numpy transliteration of
    fused_step.py's add-and-mask fed the same Philox bits, bit for bit:
    on the deviations themselves (signs, zeros, exact bf16 values and
    carries into the exponent), and through the store of f."""
    rng = np.random.default_rng(2)
    d = (0.02 * rng.standard_normal((9, 16, 12))).astype(np.float32)
    d[:, 0, 0] = 0.0
    d[:, 0, 1] = -0.0
    d[:, 0, 2] = 0.15625  # an exact bf16 value
    d[:, 0, 3] = np.uint32(0x3BFFFFFF).view(np.float32)  # low bits 0xFFFF: carries
    d[:, 0, 4] = -d[:, 0, 3]
    r = P.sr_bits(16 * 12, key).view(9, 16, 12).numpy().astype(np.uint32)
    got = K.sr_round(torch.as_tensor(d), key)
    assert np.array_equal(_bits(got) & 0xFFFF, (sr_numpy(d, r).view(np.uint32) >> 16))
    f = (WQ + d).astype(np.float32)
    got = K._store(torch.as_tensor(f), "sr", key)
    d32 = (torch.as_tensor(f) - torch.as_tensor(WQ)).numpy()  # what the store rounds
    assert np.array_equal(_bits(got) & 0xFFFF, (sr_numpy(d32, r).view(np.uint32) >> 16))


def test_sr_is_unbiased_and_rn_is_not():
    """Over 2**17 draws of one value (one store of a grid holding it
    everywhere), the mean stochastic-rounding error lies within 4
    standard errors of 0; round to nearest makes one fixed error."""
    x = np.float32(1 / 9 + 0.0123456)
    f = torch.full((9, 256, 512), float(x))
    d = (f - torch.as_tensor(WQ)).double()
    sr = K.f_from_storage(K._store(f, "sr", (7, 3)), "sr").double() - torch.as_tensor(WQ)
    err = (sr - d)[1].flatten()
    se = float(err.std()) / err.numel() ** 0.5
    assert err.numel() >= 1e5 and float(err.std()) > 0
    assert abs(float(err.mean())) <= 4 * se
    rn = K.f_from_storage(K._store(f, True, None), True).double() - torch.as_tensor(WQ)
    rn_err = (rn - d)[1]
    assert float(rn_err.std()) == 0.0 and abs(float(rn_err.mean())) > 20 * se


def _sr_run(tc, tf, ts, seed, n):
    run = K.make_fused_cylinder_runner(tc, tile_rows=8, bf16_dev="sr", seed=seed)
    out = run(dict(ts, f=K.f_to_storage(ts["f"], "sr")), tf, n)
    return run, out


def test_sr_seed_replays_and_launch_keys_are_unique(monkeypatch):
    """The same seed gives the same stored bits; another seed other bits;
    a 15-step run (three k=4 passes, one k=2 pass, one split k=1 step)
    uses 14 keys, each new: three a k-step pass (`cyl_pass`: interior, cyl,
    edge) and one each for the single step's two launches."""
    tc = T.CylinderConfig(**SPLIT)
    ts, tf = T.init(tc, "cpu")
    _, a = _sr_run(tc, tf, ts, 5, 15)
    _, b = _sr_run(tc, tf, ts, 5, 15)
    _, c = _sr_run(tc, tf, ts, 6, 15)
    assert torch.equal(a["f"].view(torch.int16), b["f"].view(torch.int16))
    assert not torch.equal(a["f"].view(torch.int16), c["f"].view(torch.int16))
    keys = []
    for name in ("cyl_full_ref", "cyl_interior_ref", "cyl_pass_ref"):
        twin = getattr(K, name)

        def spy(*args, _twin=twin, _name=name, **kw):
            pass_keys = args[10] if _name == "cyl_pass_ref" else (args[-1],)
            keys.extend((_name, k) for k in pass_keys)
            return _twin(*args, **kw)

        monkeypatch.setattr(K, name, spy)
    run, _ = _sr_run(tc, tf, ts, 5, 15)
    assert [k for _, k in keys] == [(5, i) for i in range(14)]
    assert run.keys.n == 14
    assert sorted({n for n, _ in keys}) == ["cyl_full_ref", "cyl_interior_ref", "cyl_pass_ref"]
    assert len({k for _, k in keys}) == len(keys)


@pytest.mark.parametrize("mode", [True, "sr"])
def test_bf16_runner_tracks_f32(mode):
    """Five steps of the bf16 runner (a k=4 pass and a single step) stay
    within the bf16 storage noise of the float32 runner, the bound of
    `tests/test_fused.py::test_fused_bf16_deviation_storage_close_to_f32`."""
    tc = T.CylinderConfig(**SPLIT)
    ts, tf = T.init(tc, "cpu")
    ref = K.make_fused_cylinder_runner(tc, tile_rows=8)(ts, tf, 5)
    run = K.make_fused_cylinder_runner(tc, tile_rows=8, bf16_dev=mode, seed=1)
    out = run(dict(ts, f=K.f_to_storage(ts["f"], mode)), tf, 5)
    assert out["f"].dtype == torch.bfloat16 and out["rho"].dtype == torch.float32
    torch.testing.assert_close(K.f_from_storage(out["f"], mode), ref["f"], atol=5e-4, rtol=0)
    for k in ("rho", "vel"):
        torch.testing.assert_close(out[k], ref[k], atol=2e-3, rtol=0)


def test_wrappers_refuse_storage_mismatch():
    """f in another storage than the mode's, or an SR launch without its
    key, raises before any launch."""
    tc = T.CylinderConfig(**GENERIC)
    c = K.consts(tc)
    ts, tf = T.init(tc, "cpu")
    H = tc.res[0]
    out = {k: torch.empty_like(v) for k, v in ts.items()}
    args = (ts["rho"], ts["vel"], tf["flags"], tf["phi_obs"])
    with pytest.raises(ValueError, match="dtype"):
        K.cyl_full(ts["f"], *args, out, [(0, H)], c, True)
    g = K.f_to_storage(ts["f"], True)
    with pytest.raises(ValueError, match="dtype"):
        K.cyl_full(g, *args, out, [(0, H)], c, True)
    with pytest.raises(ValueError, match="key"):
        K.cyl_interior(g, dict(out, f=torch.empty_like(g)), [(0, H)], c, True, "sr")
    with pytest.raises(ValueError, match="seed"):
        K.LaunchKeys(2 ** 32)


# --- the shedding entry point ---

def _validation(name):
    sys.path.insert(0, os.path.join(ROOT, "validation"))
    try:
        return __import__(name)
    finally:
        sys.path.remove(os.path.join(ROOT, "validation"))


def test_perturb_wake_and_williamson_match_validation():
    V = _validation("run_cylinder_shedding")
    L = _validation("run_cylinder_shedding_lowblock")
    kw = dict(res=(80, 40), D=8.0, Re=500.0, cylinder_center=(20.0, 24.0))
    jc, tc = J.CylinderConfig(**kw), T.CylinderConfig(**kw)
    js, _ = J.init(jc)
    want = V.perturb_wake(js, jc)
    got = S.perturb_wake(T.state_from_numpy({k: np.asarray(v) for k, v in js.items()}, "cpu"),
                         tc)
    for k in ("f", "rho", "vel"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    for re in (60.0, 88.6, 125.0):
        assert abs(S.williamson_st(re) - L.williamson_st(re)) <= 1e-6


JAX_KEYS = {"case", "res", "D", "blockage", "u_eff", "re_cylinder_effective", "cd_mean",
            "cl_rms", "strouhal", "strouhal_williamson_at_re_eff", "shedding"}


def test_run_case_mini_cut_down_on_cpu():
    res = S.run_case("mini", "cpu", warmup=4, n_samples=4, every=2)
    assert JAX_KEYS <= set(res)
    assert res["steps"] == 12 and res["norm"] == "nominal" and res["u_eff"] == 0.1
    assert len(res["series"]["cl"]) == 4 and np.isfinite(res["series"]["cl"]).all()


def test_run_case_sr_path_on_cpu(monkeypatch, tmp_path):
    """A small stochastic-rounding case through the entry point's fused
    runner (the twins on the CPU) and the CLI's files."""
    monkeypatch.setitem(S.CASES, "tiny_sr", dict(
        cfg=dict(SPLIT, Re=300.0), warmup=4, n_samples=3, every=4, bf16_dev="sr",
        norm="nominal"))
    assert S.main(["tiny_sr", "--device", "cpu", "--out", str(tmp_path), "--seed", "3"]) == 0
    res = json.loads((tmp_path / "cylinder_shedding_tiny_sr.json").read_text())
    assert JAX_KEYS <= set(res) and res["bf16_dev"] == "sr" and res["steps"] == 16
    series = np.load(tmp_path / "cylinder_shedding_tiny_sr_series.npz")
    assert series["cl"].shape == (3,) and np.isfinite(series["cd"]).all()
