"""The measured GEMM plan table (arcquant_tpu_torch/kernels/autotune.py)
on the CPU, where nothing is timed:

  - its buckets, keys and weight shapes equal the JAX package's
    (arcquant_tpu/kernels/autotune.py) for every model config;
  - the table's resolution order (env file, user file, shipped table),
    a missing file giving no table, and its persistence;
  - lookup_split's checks: a legal plan for the shape, a gain over the
    heuristic's measured time beyond the noise gate, no JAX-format entry,
    no fallback from the 4 and 8 buckets to 16;
  - every consumer of the plan (gemm_w8 / gemm_w4's launcher,
    gemm_batched, the three megakernels, the lab) launching the table's
    split, and the small-M tile's k order at a table split against the
    JAX package's gemm_dequant;
  - the k-tile coverage of every candidate split at Qwen2.5-7B's sites;
  - the shipped H100 table: its coverage and every entry a legal plan;
  - the engine's build hook, autotune_engine's choice of weights, the
    CLIs' shapes and ship_table's verdicts.
The JAX side's cases (tests/test_autotune.py) are mirrored where the
function is the same.
"""

import json

import numpy as np
import pytest
import torch

from arcquant_tpu.config import get_model_config as jax_model_config
from arcquant_tpu.kernels import autotune as jat
from arcquant_tpu.kernels import gemm as jgemm
from arcquant_tpu_torch.config import MODEL_CONFIGS, get_model_config
from arcquant_tpu_torch.convert import packed_from_numpy
from arcquant_tpu_torch.kernels import _build
from arcquant_tpu_torch.kernels import autotune
from arcquant_tpu_torch.kernels import gemm as gk
from arcquant_tpu_torch.kernels import gemm_lab as gl
from arcquant_tpu_torch.kernels import mlp_fused as mf
from arcquant_tpu_torch.quant import packing
from arcquant_tpu_torch.testing import to_numpy, to_torch

from test_torch_gemm import _case, assert_summation_order_close
from test_torch_gemm_small_m import _decode_sites, mainloop_emulation

SHIPPED = "arcquant_tpu_torch/kernels/autotune_tables/nvidia_h100_80gb_hbm3.json"
BUCKETS = (4, 8, 16, 32)
SELECT_FRAC = 0.125


@pytest.fixture(autouse=True)
def _no_table(tmp_path, monkeypatch):
    """Every test starts from no table (a user file that does not exist,
    no shipped table) and leaves the cache empty."""
    monkeypatch.setenv("ARC_AUTOTUNE_FILE", str(tmp_path / "none.json"))
    monkeypatch.setattr(autotune, "_shipped_table_path", lambda: None)
    autotune.invalidate_cache()
    yield
    autotune.invalidate_cache()


def _source():
    """The file the table in force was read from (None: no table)."""
    autotune._load()
    return autotune._table_src


def _table(tmp_path, monkeypatch, entries, name="tune.json"):
    path = tmp_path / name
    path.write_text(json.dumps(entries))
    monkeypatch.setenv("ARC_AUTOTUNE_FILE", str(path))
    autotune.invalidate_cache()
    return path


def _entry(splits, heuristic, ms_best, ms_heuristic, noise=None, **extra):
    e = {"splits": splits, "heuristic": heuristic,
         "ms": {str(splits): ms_best, str(heuristic): ms_heuristic}}
    if noise is not None:
        e["noise"] = noise
    e.update(extra)
    return e


def _wins(kq, n, splits, m=4, fmt="w8"):
    """A table entry at (fmt, m's bucket, kq, n) in which `splits` beats
    the heuristic by 2x."""
    h = gk.heuristic_splits(m, n, kq)
    return {autotune._key(fmt, autotune._m_bucket(m), kq, n):
            _entry(splits, h, 1.0, 2.0, noise=0.01)}


# -- buckets, keys, shapes: the JAX package's ---------------------------------

def test_bucket_and_key_match_jax():
    for m in range(1, 257):
        assert autotune._m_bucket(m) == jat._m_bucket(m), m
        assert autotune._key("w8", m, 3584, 4608) == jat._key(
            "w8", m, 3584, 4608)
    assert autotune._key("w4", 16, 2048, 168960) == "w4|16|2048|168960"


@pytest.mark.parametrize("name", sorted(MODEL_CONFIGS))
@pytest.mark.parametrize("select_num", [0, 64, 256, 448])
def test_engine_weight_shapes_match_jax(name, select_num):
    cfg, jcfg = get_model_config(name), jax_model_config(name)
    for head in (False, True):
        assert autotune.engine_weight_shapes(cfg, select_num, head) == \
            jat.engine_weight_shapes(jcfg, select_num, head), (name, head)


def test_engine_weight_shapes_legal():
    """The JAX package's test_engine_weight_shapes, and select_frac's
    per-site counts (identity_calib's rule) on Qwen2.5-7B."""
    cfg = get_model_config("qwen2.5-7b")
    shapes = autotune.engine_weight_shapes(cfg)
    assert len(shapes) == 4
    for kq, n in shapes:
        assert kq % 512 == 0 and n % 128 == 0
    arc = autotune.engine_weight_shapes(cfg, select_frac=SELECT_FRAC)
    want = sorted({(kq, n) for _, kq, n in _decode_sites()})
    assert arc == want
    moe = autotune.engine_weight_shapes(get_model_config("qwen1.5-moe-a2.7b"),
                                        select_frac=SELECT_FRAC)
    assert (2560, 60 * 2 * 1408) in moe


# -- the table file ------------------------------------------------------------

def test_missing_file_is_empty(tmp_path, monkeypatch):
    assert autotune._load() == {}
    assert _source() is None
    assert autotune.lookup_split("w8", 4, 4096, 37888) is None


def test_resolution_order(tmp_path, monkeypatch):
    """ARC_AUTOTUNE_FILE, else the user table in the temp directory, else
    the shipped table; a file that does not parse is passed over."""
    shipped = tmp_path / "shipped.json"
    shipped.write_text(json.dumps(_wins(4096, 37888, 4)))
    monkeypatch.setattr(autotune, "_shipped_table_path", lambda: str(shipped))
    user_dir = tmp_path / "tmpdir"
    user_dir.mkdir()
    monkeypatch.setattr("tempfile.tempdir", str(user_dir))
    monkeypatch.delenv("ARC_AUTOTUNE_FILE")
    user = user_dir / "arc_gemm_autotune_torch.json"
    assert autotune._user_table_path() == str(user)

    autotune.invalidate_cache()
    assert autotune.lookup_split("w8", 4, 4096, 37888) == 4
    assert _source() == str(shipped)

    user.write_text(json.dumps(_wins(4096, 37888, 2)))
    autotune.invalidate_cache()
    assert autotune.lookup_split("w8", 4, 4096, 37888) == 2
    assert _source() == str(user)

    env = _table(tmp_path, monkeypatch, _wins(4096, 37888, 8), "env.json")
    assert autotune.lookup_split("w8", 4, 4096, 37888) == 8
    assert _source() == str(env)

    env.write_text("{not json")
    autotune.invalidate_cache()
    assert autotune.lookup_split("w8", 4, 4096, 37888) == 4   # shipped


def test_read_once_until_invalidated(tmp_path, monkeypatch):
    path = _table(tmp_path, monkeypatch, _wins(4096, 37888, 4))
    assert autotune.lookup_split("w8", 4, 4096, 37888) == 4
    path.write_text(json.dumps(_wins(4096, 37888, 2)))
    assert autotune.lookup_split("w8", 4, 4096, 37888) == 4
    autotune.invalidate_cache()
    assert autotune.lookup_split("w8", 4, 4096, 37888) == 2


def test_lookup_resolved_once(tmp_path, monkeypatch):
    """lookup_split works an answer out once a shape (a launch pays one
    dict lookup); invalidate_cache and _record forget the answers."""
    _table(tmp_path, monkeypatch, _wins(4096, 37888, 4))
    calls = []
    real = autotune._resolve
    monkeypatch.setattr(autotune, "_resolve",
                        lambda *a: calls.append(a) or real(*a))
    for _ in range(3):
        assert autotune.lookup_split("w8", 4, 4096, 37888) == 4
        assert autotune.lookup_split("w8", 3, 4096, 37888) == 4
    assert calls == [("w8", 4, 4096, 37888), ("w8", 3, 4096, 37888)]
    autotune._record("w8", 4, 4096, 37888, _wins(4096, 37888, 2)[
        "w8|4|4096|37888"])
    assert autotune.lookup_split("w8", 4, 4096, 37888) == 2
    autotune.invalidate_cache()
    assert autotune.lookup_split("w8", 4, 4096, 37888) == 2
    assert len(calls) == 4


def test_record_persists(tmp_path, monkeypatch):
    """_record (what measure_packed ends with) writes the table to the user
    file, and a fresh read serves the entry."""
    path = tmp_path / "sub" / "tune.json"
    monkeypatch.setenv("ARC_AUTOTUNE_FILE", str(path))
    autotune.invalidate_cache()
    e = _entry(4, 1, 0.08, 0.1, noise=0.02, reps=5)
    autotune._record("w8", 3, 4096, 37888, e)
    saved = json.loads(path.read_text())
    assert saved == {"w8|4|4096|37888": e}
    autotune.invalidate_cache()
    assert autotune.lookup_split("w8", 4, 4096, 37888) == 4


def test_measure_packed_raises_on_cpu():
    pw = packing.pack_weight_arc(torch.randn(256, 512), None, 0)
    with pytest.raises(RuntimeError, match="GPU"):
        autotune.measure_packed(pw, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        autotune.autotune_shapes([(512, 256)], 4)


def test_should_autotune_false_on_cpu(monkeypatch):
    monkeypatch.setenv("ARC_GEMM_AUTOTUNE", "1")
    assert autotune.should_autotune("cpu") is False
    if not torch.cuda.is_available():
        assert not autotune.should_autotune()
    monkeypatch.setenv("ARC_GEMM_AUTOTUNE", "0")
    assert not autotune.should_autotune("cuda")


def test_no_shipped_table_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert autotune._device_kind_slug() is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i: "NVIDIA H100 80GB HBM3")
    assert autotune._device_kind_slug() == "nvidia_h100_80gb_hbm3"


# -- lookup_split's checks --------------------------------------------------------

def test_winner_selection(tmp_path, monkeypatch):
    """The JAX package's test_winner_selection: an entry that beats the
    heuristic is served, the heuristic's own count and a miss give None."""
    h_up = gk.heuristic_splits(4, 37888, 4096)
    h_qkv = gk.heuristic_splits(4, 4608, 4096)
    assert (h_up, h_qkv) == (1, 8)
    _table(tmp_path, monkeypatch, {
        "w8|4|4096|37888": _entry(4, 1, 0.08, 0.11),
        "w8|4|4096|4608": _entry(8, 8, 0.02, 0.02),
        "w8|4|4096|3584": _entry(4, 8, 0.03, 0.02),   # slower than h
    })
    assert autotune.lookup_split("w8", 4, 4096, 37888) == 4
    assert autotune.lookup_split("w8", 4, 4096, 4608) is None
    assert autotune.lookup_split("w8", 4, 4096, 3584) is None
    assert autotune.lookup_split("w8", 4, 1024, 1024) is None
    assert autotune.lookup_split("w4", 4, 4096, 37888) is None


def test_m_bucketing(tmp_path, monkeypatch):
    _table(tmp_path, monkeypatch, {"w8|32|4096|37888": _entry(4, 1, 1., 2.)})
    for m in (17, 30, 32):
        assert autotune.lookup_split("w8", m, 4096, 37888) == 4
    assert autotune.lookup_split("w8", 33, 4096, 37888) is None
    assert autotune.lookup_split("w8", 16, 4096, 37888) is None


def test_no_fallback_to_the_16_bucket(tmp_path, monkeypatch):
    """The JAX package serves m 4 and 8 from the 16 bucket when their own
    is missing; the port does not (a miss means the heuristic)."""
    entries = {"w8|16|4096|37888": _entry(4, 1, 1.0, 2.0),
               "w8|4|4096|4608": _entry(2, 8, 1.0, 2.0),
               "w8|16|4096|4608": _entry(4, 8, 1.0, 2.0)}
    _table(tmp_path, monkeypatch, entries)
    for m in range(1, 9):
        assert autotune.lookup_split("w8", m, 4096, 37888) is None, m
    assert autotune.lookup_split("w8", 16, 4096, 37888) == 4
    assert autotune.lookup_split("w8", 4, 4096, 4608) == 2
    assert autotune.lookup_split("w8", 8, 4096, 4608) is None
    # the JAX package's rule, for contrast
    jt = {k: {"fused": 1e-6, "dma": 2e-6} for k in entries}
    assert jat._get_entry(jt, "w8", 4, 4096, 37888) is not None


def test_noise_gate_defers_to_heuristic(tmp_path, monkeypatch):
    """The JAX package's test: a gain inside 8%, or inside the entry's own
    measured spread, leaves the heuristic; _NOISE_MARGIN (the JAX
    package's ARC_AUTOTUNE_MARGIN) moves the gate."""
    _table(tmp_path, monkeypatch, {
        "w8|4|4096|37888": _entry(4, 1, 0.104, 0.108),            # 3.8%
        "w8|4|3584|37888": _entry(4, 1, 0.080, 0.108),            # 35%
        "w8|4|2048|37888": _entry(2, 1, 0.090, 0.100, noise=0.25),
    })
    assert autotune.lookup_split("w8", 4, 4096, 37888) is None
    assert autotune.lookup_split("w8", 4, 3584, 37888) == 4
    assert autotune.lookup_split("w8", 4, 2048, 37888) is None
    monkeypatch.setattr(autotune, "_NOISE_MARGIN", 0.01)
    autotune.invalidate_cache()
    assert autotune.lookup_split("w8", 4, 4096, 37888) == 4
    assert autotune.lookup_split("w8", 4, 2048, 37888) is None


@pytest.mark.parametrize("bad", [
    0, -1, 129, 14, True, "4", 4.0, None,
    "missing-ms", "missing-heuristic-ms", "jax"])
def test_illegal_entries_ignored(bad, tmp_path, monkeypatch):
    """Kq 4096 is 128 k-tiles: 14 splits is no plan (per 10 makes 13
    splits), 129 exceeds the tiles; no "splits", no
    measured time of the split or of the heuristic's, or an entry in the
    JAX package's format (fused / dma / bk / bn) are all ignored."""
    key = "w8|4|4096|37888"
    if bad == "jax":
        e = {"fused": 1e-6, "dma": 2e-6, "bk": 512, "bn": 9472}
    elif bad == "missing-ms":
        e = {"splits": 4, "heuristic": 1, "ms": {"1": 0.1}}
    elif bad == "missing-heuristic-ms":
        e = {"splits": 4, "heuristic": 1, "ms": {"4": 0.01}}
    else:
        e = {"splits": bad, "heuristic": 1,
             "ms": {"1": 1.0, str(bad): 0.1}}
    _table(tmp_path, monkeypatch, {key: e})
    assert autotune.lookup_split("w8", 4, 4096, 37888) is None
    assert gk._split_plan(4, 37888, 4096) == (True, 1, 128)


# -- every consumer launches the table's split ----------------------------------

class _Spy:
    """Stands in for a _build.Kernel: records its arguments."""

    def __init__(self, name):
        self.name, self.calls = name, []

    def __call__(self, *args, m=None):
        self.calls.append(args)


@pytest.fixture
def spies(monkeypatch):
    """The launchers' kernels replaced by recorders, their CUDA check off:
    the launch wrappers run on CPU tensors and launch nothing."""
    monkeypatch.setattr(_build, "require_cuda", lambda *a: None)
    out = {}
    for mod, name in ((gk, "GEMM_W8"), (gk, "GEMM_W4"), (gk, "GEMM_BATCHED"),
                      (mf, "GEMM_ACTQ"), (mf, "GU_ACTQ"), (mf, "MLP_W8"),
                      (gl, "LAB_W8"), (gl, "LAB_W4")):
        out[name] = _Spy(name)
        monkeypatch.setattr(mod, name, out[name])
    return out


def _w8(n, kq, gen):
    return packing.PackedWeightI8(
        torch.randint(-12, 13, (kq, n), dtype=torch.int8, generator=gen),
        torch.randint(0, 127, (kq // 16, n), dtype=torch.uint8,
                      generator=gen),
        torch.ones(n), None)


def test_launchers_take_the_table_split(tmp_path, monkeypatch, spies):
    """M 4, Kq 2048 (64 k-tiles): the heuristic gives 4 splits at N 256 and
    N 512; a table picks 2 for w8 at N 256 and 8 for w4 at N 512. gemm_w8
    and gemm_w4 launch their format's split, gemm_batched each expert's,
    the megakernels the w8 split of each of their GEMMs, the lab its
    format's, and a format or shape without an entry the heuristic's."""
    m, kq, f = 4, 2048, 128
    assert gk.heuristic_splits(m, 256, kq) == gk.heuristic_splits(
        m, 512, kq) == 4
    _table(tmp_path, monkeypatch, {**_wins(kq, 2 * f, 2),
                                   **_wins(kq, 512, 8, fmt="w4")})
    gen = torch.Generator().manual_seed(0)
    xa = torch.randn(m, kq).bfloat16()
    gs, bf = torch.ones(m, 1), torch.bfloat16

    def plan(spy, i=-1):
        return tuple(spies[spy].calls[i][-2:])

    w = _w8(2 * f, kq, gen)
    gk._gemm_w8_cuda(xa, w.codes, w.scales, gs, torch.ones(1, 2 * f), None,
                     bf)
    assert plan("GEMM_W8") == (2, 32)
    codes4 = torch.zeros(kq // 2, 2 * f, dtype=torch.uint8)
    gk._gemm_w4_cuda(xa, codes4, w.scales, gs, torch.ones(1, 2 * f), None,
                     bf)
    assert plan("GEMM_W4") == (4, 16)        # no w4 entry at N 256
    codes4 = torch.zeros(kq // 2, 512, dtype=torch.uint8)
    scales = torch.zeros(kq // 16, 512, dtype=torch.uint8)
    gk._gemm_w4_cuda(xa, codes4, scales, gs, torch.ones(1, 512), None, bf)
    assert plan("GEMM_W4") == (8, 8)
    w8_512 = _w8(512, kq, gen)
    gk._gemm_w8_cuda(xa, w8_512.codes, w8_512.scales, gs,
                     torch.ones(1, 512), None, bf)
    assert plan("GEMM_W8") == (4, 16)        # no w8 entry at N 512

    e = 3
    gk._gemm_batched_cuda(xa.expand(e, m, kq), w.codes.expand(e, kq, 2 * f),
                          w.scales.expand(e, kq // 16, 2 * f),
                          torch.ones(e, m, 1), torch.ones(e, 1, 2 * f), bf)
    assert plan("GEMM_BATCHED") == (2, 32)
    gk._gemm_batched_cuda(xa.expand(e, m, kq), codes4.expand(e, kq // 2, 512),
                          scales.expand(e, kq // 16, 512),
                          torch.ones(e, m, 1), torch.ones(e, 1, 512), bf)
    assert plan("GEMM_BATCHED") == (8, 8)

    # gemm_actq at the o_in site: N 256 from Kq 2048
    x = torch.randn(m, kq).bfloat16()
    mf._gemm_actq_cuda(x, w, kq, bf, None, 0.0)
    assert tuple(spies["GEMM_ACTQ"].calls[-1][-3:-1]) == (2, 32)
    # gu_actq: gateup N = 2F = 256
    mf._gu_actq_cuda(xa, gs, w, f, kq, bf)
    assert plan("GU_ACTQ") == (2, 32)
    # mlp_w8: gateup at the table's 2, down [Kq2 2048, N 512] at the
    # heuristic's 4
    mf._mlp_w8_cuda(xa, gs, w, w8_512, f, bf, None, 0.0)
    assert tuple(spies["MLP_W8"].calls[-1][-4:]) == (2, 32, 4, 16)
    # the lab (its launcher; lab_w8 / lab_w4 run the plain versions on
    # CPU tensors): its format's production plan
    gl._launch(spies["LAB_W8"], False, xa, w.codes, w.scales, gs.reshape(-1),
               torch.ones(2 * f), "base", 128, 128, 3, None)
    assert plan("LAB_W8") == (2, 32)
    gl._launch(spies["LAB_W4"], True, xa, codes4, scales, gs.reshape(-1),
               torch.ones(512), "f32", 128, 128, 3, None)
    assert plan("LAB_W4") == (8, 8)
    assert gl._plan(m, 2 * f, kq) == (2, 32)
    assert gl._plan(m, 512, kq, fmt="w4") == (8, 8)
    assert mf._plan(m, w) == (2, 32)


def test_forced_split_launch(spies):
    """_gemm_cuda's `splits` (autotune's candidates) launches that plan and
    refuses one the small-M tile cannot take."""
    gen = torch.Generator().manual_seed(1)
    w = _w8(256, 2048, gen)
    xa, gs = torch.randn(4, 2048).bfloat16(), torch.ones(4, 1)
    for s, want in ((1, (1, 64)), (3, (3, 22)), (15, (13, 5)),
                    (64, (64, 1))):
        gk._gemm_w8_cuda(xa, w.codes, w.scales, gs, torch.ones(1, 256), None,
                         torch.bfloat16, splits=s)
        assert tuple(spies["GEMM_W8"].calls[-1][-2:]) == want
    for bad in (0, 65):
        with pytest.raises(ValueError, match="no plan"):
            gk._gemm_w8_cuda(xa, w.codes, w.scales, gs, torch.ones(1, 256),
                             None, torch.bfloat16, splits=bad)
    with pytest.raises(ValueError, match="no plan"):
        gk._gemm_w8_cuda(torch.randn(65, 2048).bfloat16(), w.codes, w.scales,
                         torch.ones(65, 1), torch.ones(1, 256), None,
                         torch.bfloat16, splits=2)


def test_large_m_takes_one_split(tmp_path, monkeypatch):
    """The table is consulted at M <= 64 only, as the JAX package's."""
    _table(tmp_path, monkeypatch, {"w8|80|4096|37888": _entry(4, 1, 1., 2.)})
    assert gk._split_plan(80, 37888, 4096) == (False, 1, 128)


@pytest.mark.parametrize("m", [1, 4])
@pytest.mark.parametrize("out_dtype", ["f32", "bf16"])
def test_table_split_k_order_matches_jax(m, out_dtype, tmp_path,
                                         monkeypatch):
    """The small-M tile's sums (test_torch_gemm_small_m's emulation) at a
    table split of 2 (heuristic 4) against the JAX package's gemm_dequant:
    a tuned split changes only the summation order."""
    rng = np.random.default_rng(70 + m)
    jpw, jxa, jgx = _case(rng, m, 256, 1984, 64, True)
    _table(tmp_path, monkeypatch, _wins(jpw.kq, 256, 2, m=m))
    assert gk._split_plan(m, 256, jpw.kq) == (True, 2, 32)
    jdt = jgemm.jnp.float32 if out_dtype == "f32" else jgemm.jnp.bfloat16
    tdt = torch.float32 if out_dtype == "f32" else torch.bfloat16
    ref = jgemm.gemm_dequant(jxa, jpw, jgx, out_dtype=jdt)
    pw = packed_from_numpy(jpw)
    y = mainloop_emulation(to_torch(jxa), pw.codes, pw.scales,
                           to_torch(jgx).reshape(-1, 1).float(),
                           pw.global_scale.reshape(1, -1).float(), pw.bias,
                           tdt)
    assert_summation_order_close(to_numpy(y), np.asarray(ref, np.float32),
                                 out_dtype)


@pytest.mark.parametrize("site,kq,n", _decode_sites()
                         + [("head", 3584, 152064)])
def test_every_candidate_covers_k_once(site, kq, n, tmp_path, monkeypatch):
    """test_torch_gemm_small_m's coverage check at every candidate split of
    Qwen2.5-7B's decode sites (ARC 0.125) and head, each put in a table at
    M 4: _split_plan serves it, its splits cover the k-tiles [0, Kq/32)
    once each, in order, none empty."""
    k_tiles = kq // 32
    cands = gk.split_candidates(4, n, kq)
    assert cands[0] == gk.heuristic_splits(4, n, kq)
    assert 1 in cands and len(set(cands)) == len(cands)
    assert max(cands) <= k_tiles // gk._MIN_SPLIT_TILES
    for s in cands:
        _table(tmp_path, monkeypatch, _wins(kq, n, s))
        small, splits, per = gk._split_plan(4, n, kq)
        assert small and splits == s
        covered = [kt for i in range(splits)
                   for kt in range(i * per, min((i + 1) * per, k_tiles))]
        assert covered == list(range(k_tiles)), (site, s, per)
        assert (splits - 1) * per < k_tiles


# -- the shipped H100 table --------------------------------------------------------

def _shipped_keys():
    """(fmt, bucket, kq, n) the shipped table must cover: Qwen2.5-7B's four
    sites and head select-free, its sites at ARC 0.125, Qwen1.5-MoE's
    fused gateup at both; w8 and w4; M buckets 4, 8, 16 and 32."""
    q = get_model_config("qwen2.5-7b")
    moe = get_model_config("qwen1.5-moe-a2.7b")
    up = moe.num_experts * 2 * moe.moe_intermediate_size
    shapes = set(autotune.engine_weight_shapes(q, 0, include_head=True))
    shapes |= set(autotune.engine_weight_shapes(q, select_frac=SELECT_FRAC))
    shapes |= {s for frac in (0.0, SELECT_FRAC)
               for s in autotune.engine_weight_shapes(moe, select_frac=frac)
               if s[1] == up}
    return [(fmt, b, kq, n) for fmt in ("w8", "w4") for b in BUCKETS
            for kq, n in sorted(shapes)]


def test_shipped_table_covers_and_is_legal(monkeypatch):
    with open(SHIPPED) as f:
        table = json.load(f)
    keys = _shipped_keys()
    assert len(keys) == 2 * 4 * 11
    missing = [k for k in keys if autotune._key(*k) not in table]
    assert not missing, missing
    monkeypatch.setattr(autotune, "_shipped_table_path", lambda: SHIPPED)
    monkeypatch.delenv("ARC_AUTOTUNE_FILE")
    monkeypatch.setattr("tempfile.tempdir", "/nonexistent-dir")
    autotune.invalidate_cache()
    assert _source() == SHIPPED
    for key, e in table.items():
        fmt, b, kq, n = key.split("|")
        b, kq, n = int(b), int(kq), int(n)
        assert autotune._legal(e["splits"], kq), key
        h = gk.heuristic_splits(b, n, kq)
        assert e["heuristic"] == h, key
        assert e["reps"] >= 5 and "noise" in e, key
        cands = gk.split_candidates(b, n, kq)
        assert set(e["ms"]) == {str(s) for s in cands}, key
        assert all(v > 0 for v in e["ms"].values()), key
        # shipped as measured: the fastest split, with the heuristic's
        # time beside it; lookup's gate decides
        assert min(e["ms"], key=e["ms"].get) == str(e["splits"]), key
        got = autotune.lookup_split(fmt, b, kq, n)
        t_s, t_h = e["ms"][str(e["splits"])], e["ms"][str(h)]
        beyond = t_h - t_s > autotune._noise_margin(e) * t_s
        assert got == (e["splits"] if e["splits"] != h and beyond
                       else None), key
        assert gk._split_plan(b, n, kq, fmt)[1] == (got or h), key


# -- the engine's hook and autotune_engine ------------------------------------

def _tiny_engine(monkeypatch, **kw):
    from arcquant_tpu_torch.config import QuantConfig
    from arcquant_tpu_torch.engine import EngineConfig, InferenceEngine
    from arcquant_tpu_torch.models import quantized
    cfg = get_model_config("test-tiny")
    qcfg = QuantConfig(quant_type="NVFP4", use_kernels=True,
                       weight_fmt="w8", act_scale="row", w_scale="channel",
                       quantize_lm_head=True)
    calib = quantized.identity_calib(cfg, SELECT_FRAC)
    return InferenceEngine.dummy(cfg, calib, qcfg,
                                 EngineConfig(max_batch=4, max_seq_len=64),
                                 seed=0, device="cpu", **kw)


def test_engine_tunes_only_on_cuda(monkeypatch):
    """ARC_GEMM_AUTOTUNE=1 tunes an engine on a CUDA device at its build;
    on the CPU it does not (nothing times the CPU)."""
    calls = []
    monkeypatch.setattr(autotune, "autotune_engine",
                        lambda qp, m, **kw: calls.append(m) or {})
    monkeypatch.setenv("ARC_GEMM_AUTOTUNE", "1")
    _tiny_engine(monkeypatch)
    assert calls == []
    monkeypatch.setattr(autotune, "should_autotune",
                        lambda device=None: True)
    eng = _tiny_engine(monkeypatch)
    assert calls == [4]
    assert "lm_head_packed" in eng.qparams


def test_autotune_engine_picks_2d_packed_weights(tmp_path, monkeypatch):
    """autotune_engine times each distinct 2-D w8 / w4 weight of the params
    (the head included), skips stacked experts and shapes already in the
    table, and nothing at M above the small-M tile."""
    eng = _tiny_engine(monkeypatch)
    timed = []

    def fake(pw, m, **kw):
        fmt = "w4" if isinstance(pw, packing.PackedWeight) else "w8"
        timed.append((fmt, pw.kq, pw.n))
        return {"splits": 1}
    monkeypatch.setattr(autotune, "measure_packed", fake)
    qp = dict(eng.qparams)
    w = qp["layers"][0]["qkv"]
    stacked = packing.PackedWeight(
        torch.zeros(3, 64, 128, dtype=torch.uint8),
        torch.zeros(3, 8, 128, dtype=torch.uint8), torch.ones(3), None)
    w4 = packing.pack_weight_arc(torch.randn(96, 256), None, 0, fmt="w4")
    qp["extra"] = [stacked, w4, {"again": w4}]
    have = autotune._key("w8", 4, w.kq, w.n)
    autotune._load()[have] = {"splits": 1}
    out = autotune.autotune_engine(qp, 4)
    leaves = autotune._packed_leaves(qp)
    want = {("w4" if isinstance(p, packing.PackedWeight) else "w8", p.kq,
             p.n) for p in leaves if p.codes.dim() == 2}
    assert ("w8", w.kq, w.n) in want and ("w4", w4.kq, w4.n) in want
    head = eng.qparams["lm_head_packed"]
    assert ("w8", head.kq, head.n) in want
    assert sorted(timed) == sorted(want - {("w8", w.kq, w.n)})
    assert len(timed) == len(set(timed))
    assert set(out) == {autotune._key(f, 4, kq, n) for f, kq, n in want}
    timed.clear()
    assert autotune.autotune_engine(qp, 65) == {} and not timed


# -- the CLIs and the timer ---------------------------------------------------------

def test_gemm_autotune_shapes():
    from arcquant_tpu_torch.benchmarks import gemm_autotune as ga
    args = ga.parse_args(["--model", "qwen2.5-7b", "--head",
                          "--shapes", "4096x37888,128x256"])
    shapes = ga.shapes_of(args)
    cfg = get_model_config("qwen2.5-7b")
    assert shapes == sorted(set(autotune.engine_weight_shapes(cfg, 0, True))
                            | {(128, 256), (4096, 37888)})
    args = ga.parse_args(["--select_frac", "0.125", "--model", "qwen2.5-7b"])
    assert ga.shapes_of(args) == sorted({(kq, n)
                                         for _, kq, n in _decode_sites()})
    assert ga.parse_args([]).reps >= 5
    s = ga.summary("k", _entry(4, 1, 0.08, 0.1, noise=0.02))
    assert s["heuristic_over_best"] == 1.25 and s["splits"] == 4
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ga.main(["--m", "4"])


def test_ship_table_verdicts(tmp_path, monkeypatch, capsys):
    """ship_table ships every entry as measured and flags one inside the
    gate (lookup_split keeps the heuristic for it), skips a JAX-format
    entry, merges into the destination and leaves it alone with --dry."""
    from arcquant_tpu_torch.benchmarks import ship_table as st
    src = tmp_path / "src.json"
    src.write_text(json.dumps({
        "w8|4|4096|37888": _entry(4, 1, 0.080, 0.108, noise=0.02, reps=5),
        "w8|4|3584|37888": _entry(4, 1, 0.104, 0.108, noise=0.02, reps=5),
        "w8|4|3584|4608": _entry(7, 7, 0.02, 0.02, noise=0.02, reps=5),
        "w8|4|1024|1024": {"fused": 1e-6, "dma": 2e-6}}))
    dst = tmp_path / "dst.json"
    dst.write_text(json.dumps({"w4|4|2048|2048": _entry(1, 1, 1.0, 1.0)}))
    st.main(["--src", str(src), "--dst", str(dst), "--dry"])
    assert json.loads(dst.read_text()) == {
        "w4|4|2048|2048": _entry(1, 1, 1.0, 1.0)}
    out = st.main(["--src", str(src), "--dst", str(dst)])
    text = capsys.readouterr().out
    assert "INSIDE NOISE" in text and "not a split entry" in text
    saved = json.loads(dst.read_text())
    assert saved == out and len(saved) == 4
    assert saved["w8|4|4096|37888"]["splits"] == 4
    assert saved["w8|4|3584|37888"]["splits"] == 4
    assert all(saved[k] == json.loads(src.read_text())[k] for k in (
        "w8|4|4096|37888", "w8|4|3584|37888", "w8|4|3584|4608"))
    _table(tmp_path, monkeypatch, saved, "dst.json")
    assert autotune.lookup_split("w8", 4, 4096, 37888) == 4
    assert autotune.lookup_split("w8", 4, 3584, 37888) is None
    assert autotune.lookup_split("w8", 4, 3584, 4608) is None


def test_one_timer(tmp_path):
    """benchmarks/common re-exports utils/timing's Timer and Timing (one
    timer); Timer needs the card; profile_trace writes a trace."""
    from arcquant_tpu_torch.benchmarks import common
    from arcquant_tpu_torch.utils import timing
    assert common.Timer is timing.Timer and common.Timing is timing.Timing
    assert "class Timer" not in open(common.__file__).read()
    with pytest.raises(ValueError):
        timing.Timer(4)
    with timing.profile_trace(str(tmp_path / "trace")) as prof:
        torch.ones(64).sum()
    assert prof.key_averages() is not None
    assert list((tmp_path / "trace").iterdir())
