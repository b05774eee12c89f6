"""repro_torch.profiler and the block table against the reference's
repro.profiler: the cases of tests/test_profiler.py on the port (backend
names torch / cuda / conv for jnp / pallas / xla), plus the two packages
held against each other through numpy — identical trace-store lines and
crcs (each parses the other's, torn or corrupt lines counted by the same
reasons), bit-equal cost-model fits and predictions, the same ``choose``
outcome on mapped stores, the block table's keys — and the port's own
contracts: ``config_features`` equals the built plan's modelled bytes
and launches without building it, and ``backend="auto"`` resolves on the
CPU to ``torch/levels`` and never to ``cuda`` for float64.

Every test points ``$REPRO_TORCH_PROFILE_STORE`` /
``$REPRO_TORCH_BLOCK_TABLE`` (and the reference's two) at its own
``tmp_path``, so no test reads or writes the default files.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

import repro_torch as R
from repro_torch import engine as TE
from repro_torch import profiler as PF
from repro_torch import telemetry as T
from repro_torch.engine import autotune as AT
from repro_torch.engine import backends as TB
from repro_torch.faults import inject as PFJ
from repro_torch.kernels import polyphase as PP
from repro_torch.kernels import tap_window as TW
from repro_torch.profiler import auto as PA
from repro_torch.profiler import store as PST
from repro_torch.serve import metrics as SM

from repro import engine as JE
from repro import profiler as JPF
from repro.engine import autotune as JAT
from repro.profiler import store as JST

#: the port's backend names for the reference's
BACKEND_NAMES = {"jnp": "torch", "pallas": "cuda", "xla": "conv"}


@pytest.fixture(autouse=True)
def _port_planes(tmp_path, monkeypatch):
    """The port's telemetry, fault and serving planes isolated per test,
    both packages' stores and tables in ``tmp_path``, and a clean plan
    cache (an "auto" plan cached by another test would skip its
    resolution)."""
    for env, name in ((PST.STORE_ENV, "PROFILE_STORE_TORCH.jsonl"),
                      (AT.TABLE_ENV, "BLOCK_TABLE_TORCH.json"),
                      (JST.STORE_ENV, "PROFILE_STORE.jsonl"),
                      (JAT.TABLE_ENV, "BLOCK_TABLE.json")):
        monkeypatch.setenv(env, str(tmp_path / name))
    AT.clear_cache()
    JAT.clear_cache()
    prev_mode = T.mode()
    prev_plan = PFJ.activate(None)
    T.set_mode("counters")
    T.reset()
    SM.reset()
    TE.clear_plan_cache()
    yield
    PFJ.activate(prev_plan)
    T.set_mode(prev_mode)
    T.reset()
    SM.reset()
    TE.clear_plan_cache()
    AT.clear_cache()
    JAT.clear_cache()


def _key(shape=(2, 32, 32), backend="auto", fuse="none", levels=2,
         scheme="ns-polyconv", **kw):
    return TE.PlanKey(wavelet="cdf97", scheme=scheme, levels=levels,
                      shape=shape, dtype="float32", backend=backend,
                      optimize=False, fuse=fuse, boundary="periodic",
                      device="cpu", **kw)


def _jkey(shape=(2, 32, 32), backend="auto", fuse="none", levels=2,
          scheme="ns-polyconv"):
    return JE.PlanKey(wavelet="cdf97", scheme=scheme, levels=levels,
                      shape=shape, dtype="float32", backend=backend,
                      optimize=False, fuse=fuse, boundary="periodic")


def _rec(key, backend, fuse, time_s, tap_opt="full", block=None):
    """Synthetic measured record of ``key`` under one candidate config."""
    concrete = dataclasses.replace(key, backend=backend, fuse=fuse,
                                   tap_opt=tap_opt)
    feats = PF.config_features(concrete)
    return PST.record_from_key(concrete, block, time_s, feats["hbm_bytes"],
                               feats["launches"])


def _jrec(key, backend, fuse, time_s):
    concrete = dataclasses.replace(key, backend=backend, fuse=fuse,
                                   tap_opt="full")
    feats = JPF.config_features(concrete)
    return JST.record_from_key(concrete, None, time_s, feats["hbm_bytes"],
                               feats["launches"])


@pytest.fixture
def store(tmp_path):
    """The port's isolated trace store (also the process default)."""
    return PF.TraceStore(PST.store_path())


# ---------------------------------------------------------------------------
# Device fingerprint + fingerprint-keyed block table
# ---------------------------------------------------------------------------

def test_device_fingerprint_deterministic():
    fp = AT.device_fingerprint("cpu")
    assert fp == AT.device_fingerprint(torch.device("cpu")) == "cpu:cpu"
    assert ":" in fp and "|" not in fp    # "|" is the table-key separator
    # on the CPU the reference's process fingerprint is the same string
    assert fp == JAT.device_fingerprint()


def test_cuda_fingerprint_and_auto_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        AT.device_fingerprint("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        R.dwt2(torch.zeros(2, 16, 16), backend="auto")


def test_block_table_keys_carry_fingerprint(tmp_path):
    AT.save_entry("ns-polyconv", (64, 64), "levels", "cuda", (16, 32),
                  device="cpu")
    table = json.loads(AT.table_path().read_text())
    (key,) = table
    assert key.endswith("|cpu:cpu")
    assert AT.lookup("ns-polyconv", (64, 64), "levels", "cuda", "cpu") \
        == (16, 32)
    # the key format is the reference's: its table reads the entry back
    assert key == JAT.table_key("ns-polyconv", (64, 64), "levels", "cuda",
                                JAT.device_fingerprint())
    JAT.save_entry("ns-polyconv", (64, 64), "levels", "pallas", (16, 32),
                   path=AT.table_path())
    AT.clear_cache()
    assert AT.lookup("ns-polyconv", (64, 64), "levels", "pallas", "cpu") \
        == (16, 32)


def test_block_table_foreign_fingerprint_falls_back():
    AT.save_entry("ns-polyconv", (64, 64), "levels", "cuda", (64, 64),
                  fingerprint="cuda:NVIDIA Elsewhere")
    before = AT.COUNTERS["device_fallbacks"]
    assert AT.lookup("ns-polyconv", (64, 64), "levels", "cuda",
                     "cpu") is None
    assert AT.COUNTERS["device_fallbacks"] == before + 1
    # a legacy un-fingerprinted entry is also a mismatch, not a match
    path = AT.table_path()
    table = json.loads(path.read_text())
    table[AT.table_key("sep-conv", (64, 64), "levels", "cuda")] = [8, 8]
    path.write_text(json.dumps(table))
    AT.clear_cache()
    assert AT.lookup("sep-conv", (64, 64), "levels", "cuda", "cpu") is None
    assert AT.COUNTERS["device_fallbacks"] == before + 2
    # a config with no entry at all is silent (no counter bump)
    assert AT.lookup("ns-conv", (64, 64), "levels", "cuda", "cpu") is None
    assert AT.COUNTERS["device_fallbacks"] == before + 2
    assert TE.stats()["block_table"] == {
        "device_fallbacks": before + 2, "path": str(path)}


def test_block_table_memoized_per_path(tmp_path, monkeypatch):
    """The table file is read once per path: rewriting it behind the
    memo's back is invisible until the path changes or the cache is
    cleared (save_entry clears it)."""
    def write(p, block):
        p.write_text(json.dumps(
            {AT.table_key("ns-polyconv", (64, 64), "levels", "cuda",
                          "cpu:cpu"): block}))
    p1 = tmp_path / "t1.json"
    write(p1, [16, 32])
    monkeypatch.setenv(AT.TABLE_ENV, str(p1))
    assert AT.lookup("ns-polyconv", (64, 64), "levels", "cuda",
                     "cpu") == (16, 32)
    write(p1, [8, 8])
    assert AT.lookup("ns-polyconv", (64, 64), "levels", "cuda",
                     "cpu") == (16, 32)      # memoized: no re-read
    p2 = tmp_path / "t2.json"
    write(p2, [32, 16])
    monkeypatch.setenv(AT.TABLE_ENV, str(p2))
    assert AT.lookup("ns-polyconv", (64, 64), "levels", "cuda",
                     "cpu") == (32, 16)


def test_block_table_entry_steers_the_plan_through_the_guard():
    """A table entry is a block *target*: build_plan starts the guard
    from it (an explicit block_target skips the table), and an entry no
    block can fit at is shrunk by the guard like the default."""
    key = _key(shape=(2, 64, 128), backend="cuda", fuse="levels", levels=1)
    default = TE.build_plan(key).level_specs[0].block
    AT.save_entry("ns-polyconv", (64, 128), "levels", "cuda", (8, 16),
                  device="cpu")
    tuned = TE.build_plan(key)
    progs = tuned.level_specs[0].fwd_programs + \
        tuned.level_specs[0].inv_programs
    assert tuned.level_specs[0].block == TW.fit_block(progs, 32, 64,
                                                      (8, 16)) == (8, 16)
    assert tuned.level_specs[0].block != default
    assert TE.build_plan(key, block_target=(32, 64)).level_specs[0].block \
        == default
    AT.save_entry("ns-polyconv", (64, 128), "levels", "cuda", (4096, 4096),
                  device="cpu")
    huge = TE.build_plan(key).level_specs[0].block
    assert huge == TW.fit_block(progs, 32, 64, (4096, 4096))
    assert all(TW.smem_bytes(p, huge) <= TW.SMEM_LIMIT for p in progs)
    x = torch.from_numpy(np.random.default_rng(0)
                         .standard_normal((2, 64, 128)).astype(np.float32))
    a, b = tuned.execute(x), TE.build_plan(key, (32, 64)).execute(x)
    assert torch.equal(a.ll, b.ll)


# ---------------------------------------------------------------------------
# Trace store
# ---------------------------------------------------------------------------

def test_store_round_trip_identical_predictions(store):
    key = _key()
    recs = [_rec(key, "torch", "none", 1e-3),
            _rec(key, "torch", "levels", 8e-4),
            _rec(key, "conv", "levels", 5e-4),
            _rec(dataclasses.replace(key, shape=(2, 64, 64)),
                 "torch", "levels", 3e-3),
            _rec(dataclasses.replace(key, shape=(2, 128, 128)),
                 "torch", "levels", 1.2e-2)]
    store.extend(recs)
    reloaded = PF.TraceStore(store.path).records("cpu:cpu")
    assert reloaded == recs
    m1 = PF.CostModel.fit(recs)
    m2 = PF.CostModel.fit(reloaded)
    probe = PF.config_features(
        dataclasses.replace(key, backend="torch", fuse="levels",
                            shape=(2, 96, 96), tap_opt="full"))
    for backend, fuse in (("torch", "none"), ("torch", "levels"),
                          ("conv", "levels")):
        p1 = m1.predict(backend, fuse, probe["hbm_bytes"],
                        probe["launches"])
        assert p1 == m2.predict(backend, fuse, probe["hbm_bytes"],
                                probe["launches"])
        assert p1 is not None and p1 > 0


def test_store_skips_malformed_lines_and_filters_fingerprint(store):
    key = _key()
    store.append(_rec(key, "torch", "none", 1e-3))
    with open(store.path, "a") as f:
        f.write("not json at all\n")
        f.write(json.dumps({"v": 99, "time_s": 1.0}) + "\n")
        f.write(json.dumps({"v": 1, "wavelet": "cdf97"}) + "\n")  # missing
    foreign = dataclasses.replace(_rec(key, "conv", "levels", 2e-3),
                                  fingerprint="cuda:NVIDIA Elsewhere")
    store.append(foreign)
    assert len(store) == 2               # malformed lines dropped
    mine = store.records("cpu:cpu")
    assert len(mine) == 1 and mine[0].backend == "torch"


def test_store_caches_by_stamp_and_invalidates_on_append(store):
    key = _key()
    store.append(_rec(key, "torch", "none", 1e-3))
    assert len(store.records()) == 1
    store.append(_rec(key, "torch", "levels", 9e-4))
    assert len(store.records()) == 2     # append invalidates the cache
    assert len(PF.TraceStore(store.path)) == 2


def test_store_line_and_crc_identical_in_both_packages(tmp_path):
    """One record, written by either package, is the same line (same
    payload, same crc), and each package parses the other's."""
    fields = dict(fingerprint="cpu:cpu", wavelet="cdf97",
                  scheme="ns-polyconv", levels=2, shape=(2, 32, 32),
                  dtype="float32", backend="jnp", optimize=False,
                  fuse="levels", boundary="periodic",
                  compute_dtype="float32", tap_opt="full", tiles=None,
                  block=(16, 32), time_s=1.25e-3, hbm_bytes=123456,
                  launches=2, meta={"plan_launches": 2, "note": "x"})
    mine, theirs = PST.TraceRecord(**fields), JST.TraceRecord(**fields)
    assert mine.to_json() == theirs.to_json()
    assert json.loads(mine.to_json())["crc"] == \
        json.loads(theirs.to_json())["crc"]
    assert dataclasses.asdict(PST.parse_line(theirs.to_json())[0]) == \
        dataclasses.asdict(mine)
    assert dataclasses.asdict(JST.parse_line(mine.to_json())[0]) == \
        dataclasses.asdict(theirs)
    # a port-written store is a valid reference store, and back
    PF.TraceStore(tmp_path / "a.jsonl").append(mine)
    assert [dataclasses.asdict(r) for r in
            JPF.TraceStore(tmp_path / "a.jsonl").records()] == \
        [dataclasses.asdict(theirs)]


def test_corrupt_lines_counted_by_the_same_reasons(tmp_path):
    from repro import telemetry as JT
    good = PST.TraceRecord(
        fingerprint="cpu:cpu", wavelet="cdf97", scheme="ns-polyconv",
        levels=1, shape=(1, 16, 16), dtype="float32", backend="torch",
        optimize=False, fuse="none", boundary="periodic",
        compute_dtype="float32", tap_opt="full", tiles=None, block=None,
        time_s=1e-3, hbm_bytes=10, launches=0).to_json()
    tampered = good.replace('"time_s": 0.001', '"time_s": 1e-09')
    lines = [good, tampered, good[:40], "not json", "[1, 2]",
             json.dumps({"v": 2}), json.dumps({"v": 1, "wavelet": "x"}), ""]
    path = tmp_path / "s.jsonl"
    path.write_text("\n".join(lines) + "\n")
    JT.reset()
    assert len(PF.TraceStore(path).records()) == 1
    assert len(JPF.TraceStore(path).records()) == 1

    def reasons(counter):
        return {s["labels"]["reason"]: s["value"] for s in counter.series()}
    from repro.profiler.store import CORRUPT_RECORDS as JCORRUPT
    assert reasons(PST.CORRUPT_RECORDS) == reasons(JCORRUPT) == {
        "checksum": 1, "parse": 2, "schema": 3}


# ---------------------------------------------------------------------------
# Features + cost model
# ---------------------------------------------------------------------------

def test_config_features_sanity():
    key = _key(shape=(2, 64, 64))
    f_torch = PF.config_features(key, backend="torch", fuse="none",
                                 tap_opt="full")
    f_none = PF.config_features(key, backend="cuda", fuse="none",
                                tap_opt="full")
    f_lvl = PF.config_features(key, backend="cuda", fuse="levels",
                               tap_opt="full")
    f_pyr = PF.config_features(key, backend="cuda", fuse="pyramid",
                               tap_opt="full")
    f_conv = PF.config_features(key, backend="conv", fuse="levels",
                                tap_opt="full")
    for f in (f_torch, f_none, f_lvl, f_pyr, f_conv):
        assert f["hbm_bytes"] > 0
    assert f_torch["launches"] == 0
    assert f_pyr["launches"] == 1
    assert f_lvl["launches"] == f_conv["launches"] == key.levels
    assert f_none["launches"] > f_lvl["launches"]    # steps/level > 1
    # per-level launches move the fused pyramid's modelled bytes: K1
    # reads each level's image and writes it back as K2/K3 do, so no
    # split/merge pass runs between the levels of either
    big = _key(shape=(1, 512, 512), levels=3)
    assert PF.config_features(big, backend="cuda", fuse="pyramid")[
        "hbm_bytes"] == PF.config_features(big, backend="cuda",
                                           fuse="levels")["hbm_bytes"]
    # batch dims scale bytes linearly, launches stay fixed
    f2 = PF.config_features(_key(shape=(4, 64, 64)), backend="cuda",
                            fuse="levels", tap_opt="full")
    assert f2["hbm_bytes"] == 2 * f_lvl["hbm_bytes"]
    assert f2["launches"] == f_lvl["launches"]


_FEATURE_KEYS = (
    [dict(shape=s, levels=l, backend=b, fuse=f, scheme=sc, tap_opt=t)
     for s, l in (((2, 32, 32), 2), ((1, 64, 96), 3))
     for b, fuses in (("torch", ("none", "levels", "pyramid")),
                      ("cuda", ("none", "scheme", "levels", "pyramid")),
                      ("conv", ("none", "levels")))
     for f in fuses
     for sc in ("ns-polyconv", "sep-lifting")
     for t in (("full", "off") if b == "cuda" else ("full",))]
    + [dict(shape=(1, 64, 64), levels=2, backend=b, fuse=f,
            packet=R.PacketTree.from_spec("full:2").leaves,
            scheme="ns-polyconv", tap_opt="full")
       for b in ("cuda", "conv") for f in ("none", "levels")]
    + [dict(shape=(8, 32, 32), levels=2, backend=b, fuse=f, ndim=3,
            scheme="ns-polyconv", tap_opt="full")
       for b in ("cuda", "torch") for f in ("none", "levels", "pyramid")])


@pytest.mark.parametrize("kw", _FEATURE_KEYS,
                         ids=lambda kw: "-".join(str(v) for v in kw.values()))
def test_config_features_equal_the_built_plan(kw, monkeypatch):
    """config_features(key) is plan_hbm_bytes(plan) and plan.launches of
    the plan build_plan makes — computed without building it or encoding
    a table."""
    key = TE.PlanKey(wavelet="cdf97", dtype="float32", optimize=False,
                     boundary="periodic", device="cpu", **kw)
    plan = TE.build_plan(key)
    want = {"hbm_bytes": PP.plan_hbm_bytes(plan),
            "launches": plan.launches}

    def refuse(*a, **k):
        raise AssertionError("config_features encoded a table")
    from repro_torch.kernels import pyramid_window as PW
    monkeypatch.setattr(TW, "encode", refuse)
    monkeypatch.setattr(PW, "_encode", refuse)
    monkeypatch.setattr(TE.plan, "build_plan", refuse, raising=False)
    assert PF.config_features(key) == want


def test_config_features_follow_packets_fallbacks_and_the_table(
        monkeypatch):
    pk = TE.get_plan(shape=(64, 64), packet="full:2", backend="cuda",
                     fuse="levels", device="cpu", cache=TE.PlanCache())
    assert PF.config_features(pk.key) == {
        "hbm_bytes": PP.plan_hbm_bytes(pk), "launches": pk.launches}
    # a budget no level fits: the pyramid key runs (and is featurized)
    # as "levels"
    monkeypatch.setenv("REPRO_TORCH_PYRAMID_SMEM_LIMIT", "4096")
    key = _key(shape=(2, 64, 64), backend="cuda", fuse="pyramid")
    plan = TE.build_plan(key)
    assert plan.pyramid is None and plan.fallback
    assert PF.config_features(key) == {
        "hbm_bytes": PP.plan_hbm_bytes(plan), "launches": plan.launches}
    monkeypatch.delenv("REPRO_TORCH_PYRAMID_SMEM_LIMIT")
    # a table entry moves the blocks of both
    AT.save_entry("ns-polyconv", (64, 64), "levels", "cuda", (8, 8),
                  device="cpu")
    key = _key(shape=(2, 64, 64), backend="cuda", fuse="levels")
    plan = TE.build_plan(key)
    assert plan.level_specs[0].block == (8, 8)
    assert PF.config_features(key)["hbm_bytes"] == PP.plan_hbm_bytes(plan)


def test_cost_model_fit_and_predict_synthetic():
    key = _key()
    shapes = [(1, 32, 32), (1, 64, 64), (1, 128, 128), (1, 256, 256)]
    recs = []
    for s in shapes:
        b = PF.config_features(
            dataclasses.replace(key, shape=s, backend="torch",
                                fuse="levels", tap_opt="full"))["hbm_bytes"]
        recs.append(_rec(dataclasses.replace(key, shape=s), "torch",
                         "levels", b * 1e-12 + 1e-4))
    model = PF.CostModel.fit(recs)
    assert model.can_predict("torch", "levels")
    assert not model.can_predict("cuda", "pyramid")
    assert model.predict("cuda", "pyramid", 10**6, 1) is None
    probe = PF.config_features(
        dataclasses.replace(key, shape=(1, 96, 96), backend="torch",
                            fuse="levels", tap_opt="full"))
    pred = model.predict("torch", "levels", probe["hbm_bytes"],
                         probe["launches"])
    truth = probe["hbm_bytes"] * 1e-12 + 1e-4
    assert pred == pytest.approx(truth, rel=0.35)  # nn-blend is approximate


def test_cost_model_bit_equal_to_the_reference():
    """One record set, fit by both packages: identical groups, fitted
    coefficients and predictions, bit for bit."""
    rng = np.random.default_rng(3)
    fields = []
    for i in range(12):
        backend, fuse = [("jnp", "levels"), ("xla", "levels"),
                         ("pallas", "none")][i % 3]
        fields.append(dict(
            fingerprint="cpu:cpu", wavelet="cdf97", scheme="ns-polyconv",
            levels=2, shape=(1, 32 << (i % 4), 32 << (i % 4)),
            dtype="float32", backend=backend, optimize=False, fuse=fuse,
            boundary="periodic", compute_dtype="float32", tap_opt="full",
            tiles=None, block=None,
            time_s=float(rng.uniform(1e-4, 1e-2)),
            hbm_bytes=int(rng.integers(1e4, 1e8)),
            launches=int(rng.integers(0, 8))))
    mine = PF.CostModel.fit([PST.TraceRecord(**f) for f in fields])
    theirs = JPF.CostModel.fit([JST.TraceRecord(**f) for f in fields])
    assert mine.groups == theirs.groups and mine.coef == theirs.coef
    for b in (1, 5000, 10**6, 3 * 10**8):
        for group in (("jnp", "levels"), ("xla", "levels"),
                      ("pallas", "none"), ("jnp", "none")):
            assert mine.predict(*group, b, 3) == theirs.predict(*group, b, 3)


# ---------------------------------------------------------------------------
# choose(): cold / warm / model paths + counters
# ---------------------------------------------------------------------------

def test_choose_cold_store_uses_heuristic(store):
    before = dict(PA.AUTO_COUNTERS)
    choice = PF.choose(_key(), store=store)
    assert choice.source == "heuristic"
    assert PA.AUTO_COUNTERS["cold_fallbacks"] == \
        before["cold_fallbacks"] + 1
    # on the CPU: the torch reference at "levels" (the reference's jnp)
    assert (choice.backend, choice.fuse) == ("torch", "levels")
    TB.get_backend(choice.backend).validate(
        dataclasses.replace(_key(), backend=choice.backend,
                            fuse=choice.fuse, tap_opt=choice.tap_opt))


def test_cold_rule_on_a_cuda_key_prefers_the_pyramid_kernel():
    """The rule reads the key's device, not the process: a CUDA key
    resolves to cuda/pyramid (cuda/levels at one level), falling through
    to torch where "cuda" cannot run (float64)."""
    k = dataclasses.replace(_key(levels=3), device="cuda:0")
    assert (PA._heuristic(k).backend, PA._heuristic(k).fuse) == \
        ("cuda", "pyramid")
    one = dataclasses.replace(k, levels=1)
    assert (PA._heuristic(one).backend, PA._heuristic(one).fuse) == \
        ("cuda", "levels")
    f64 = dataclasses.replace(k, dtype="float64")
    assert (PA._heuristic(f64).backend, PA._heuristic(f64).fuse) == \
        ("torch", "levels")


def test_enumerate_candidates_keeps_what_validate_accepts():
    assert PF.enumerate_candidates(_key()) == [
        ("conv", f, "full") for f in ("none", "scheme", "levels")] + [
        ("cuda", f, "full") for f in ("none", "scheme", "levels",
                                      "pyramid")] + [
        ("torch", f, "full") for f in ("none", "scheme", "levels",
                                       "pyramid")]
    f64 = PF.enumerate_candidates(dataclasses.replace(_key(),
                                                      dtype="float64"))
    assert all(b != "cuda" for b, _, _ in f64) and f64
    pk = PF.enumerate_candidates(dataclasses.replace(
        _key(shape=(64, 64)), packet=("a", "h", "v", "d"), levels=1))
    assert all(f != "pyramid" for _, f, _ in pk) and pk
    vol = PF.enumerate_candidates(dataclasses.replace(
        _key(shape=(4, 16, 16)), ndim=3, levels=1))
    assert all(f != "pyramid" for _, f, _ in vol) and vol


def test_choose_store_hit_picks_measured_argmin(store):
    key = _key()
    store.extend([_rec(key, "torch", "none", 5e-3),
                  _rec(key, "torch", "levels", 3e-3),
                  _rec(key, "conv", "levels", 1e-3),
                  _rec(key, "cuda", "levels", 2e-3)])
    before = dict(PA.AUTO_COUNTERS)
    choice = PF.choose(key, store=store)
    assert choice.source == "store"
    assert (choice.backend, choice.fuse) == ("conv", "levels")
    assert choice.predicted_s == pytest.approx(1e-3)
    assert PA.AUTO_COUNTERS["store_hits"] == before["store_hits"] + 1
    assert PA.auto_stats()["choices"]["conv|levels"] >= 1
    store.append(_rec(key, "torch", "levels", 1e-5))
    c2 = PF.choose(key, store=store)
    assert (c2.backend, c2.fuse) == ("torch", "levels")


def test_choose_unseen_shape_uses_model(store):
    key = _key(shape=(2, 32, 32))
    for shape, t in (((2, 32, 32), 1e-3), ((2, 64, 64), 4e-3),
                     ((2, 128, 128), 1.6e-2)):
        k = dataclasses.replace(key, shape=shape)
        store.extend([_rec(k, "torch", "levels", t),
                      _rec(k, "conv", "levels", 10 * t)])
    before = dict(PA.AUTO_COUNTERS)
    choice = PF.choose(_key(shape=(2, 96, 96)), store=store)
    assert choice.source == "model"
    assert PA.AUTO_COUNTERS["predictions"] == before["predictions"] + 1
    assert (choice.backend, choice.fuse) == ("torch", "levels")
    assert choice.predicted_s is not None and choice.predicted_s > 0


def test_choose_block_comes_from_store_record(store):
    key = _key()
    store.append(_rec(key, "cuda", "levels", 1e-4, block=(16, 32)))
    choice = PF.choose(key, store=store)
    assert (choice.backend, choice.block) == ("cuda", (16, 32))
    # an explicit caller block_target suppresses the store's annotation
    assert PF.choose(key, store=store, block_target=(8, 8)).block is None
    plan = TE.get_plan(shape=(2, 32, 32), levels=2, backend="auto",
                       device="cpu", cache=TE.PlanCache())
    assert plan.level_specs[0].block == (16, 16)    # (16, 32) fit to 16^2


_CHOOSE_CASES = {
    "store": ([((2, 32, 32), "jnp", "none", 5e-3),
               ((2, 32, 32), "jnp", "levels", 3e-3),
               ((2, 32, 32), "xla", "levels", 1e-3),
               ((2, 32, 32), "pallas", "levels", 2e-3)], (2, 32, 32)),
    "model": ([(s, b, "levels", t * (10 if b == "xla" else 1))
               for s, t in (((2, 32, 32), 1e-3), ((2, 64, 64), 4e-3),
                            ((2, 128, 128), 1.6e-2))
               for b in ("jnp", "xla")], (2, 96, 96)),
    "cold": ([], (2, 32, 32)),
}


@pytest.mark.parametrize("case", sorted(_CHOOSE_CASES))
def test_choose_agrees_with_the_reference_on_mapped_stores(case, tmp_path):
    """The same measurements, under the port's backend names, resolve to
    the same (backend, fuse, source) in both packages."""
    rows, probe = _CHOOSE_CASES[case]
    mine = PF.TraceStore(tmp_path / "mine.jsonl")
    theirs = JPF.TraceStore(tmp_path / "theirs.jsonl")
    mine.extend([_rec(_key(shape=s), BACKEND_NAMES[b], f, t)
                 for s, b, f, t in rows])
    theirs.extend([_jrec(_jkey(shape=s), b, f, t) for s, b, f, t in rows])
    a = PF.choose(_key(shape=probe), store=mine)
    b = JPF.choose(_jkey(shape=probe), store=theirs)
    assert (a.backend, a.fuse, a.source) == \
        (BACKEND_NAMES[b.backend], b.fuse, b.source)
    assert a.source == case if case != "cold" else a.source == "heuristic"


# ---------------------------------------------------------------------------
# backend="auto" end to end
# ---------------------------------------------------------------------------

def _x(shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed)
                            .standard_normal(shape).astype(np.float32))


def test_dwt2_auto_cold_bit_identical(store):
    x = _x((2, 32, 32))
    cache = TE.PlanCache()
    plan = TE.get_plan(shape=(2, 32, 32), levels=2, backend="auto",
                       device="cpu", cache=cache)
    assert plan.auto is not None and plan.auto.source == "heuristic"
    assert (plan.key.backend, plan.key.fuse) == ("torch", "levels")
    manual = TE.get_plan(shape=(2, 32, 32), levels=2,
                         backend=plan.key.backend, fuse=plan.key.fuse,
                         tap_opt=plan.key.tap_opt, device="cpu",
                         cache=cache)
    pa, pm = plan.execute(x), manual.execute(x)
    assert torch.equal(pa.ll, pm.ll)
    for da, dm in zip(pa.details, pm.details):
        for a, m in zip(da, dm):
            assert torch.equal(a, m)
    torch.testing.assert_close(plan.execute_inverse(pa), x, rtol=1e-3,
                               atol=1e-4)
    # through the public entry points
    pyr = R.dwt2(x, levels=2, backend="auto", device="cpu")
    assert torch.equal(pyr.ll, pm.ll)
    torch.testing.assert_close(R.idwt2(pyr, backend="auto", device="cpu"),
                               x, rtol=1e-3, atol=1e-4)


def test_dwt2_auto_warm_follows_store(store):
    shape = (2, 32, 32)
    key = _key(shape=shape)
    store.extend([_rec(key, "torch", "none", 5e-3),
                  _rec(key, "conv", "levels", 1e-4),
                  _rec(key, "torch", "levels", 3e-3)])
    x = _x(shape, seed=1)
    plan = TE.get_plan(shape=shape, levels=2, backend="auto", device="cpu",
                       cache=TE.PlanCache())
    assert plan.auto.source == "store"
    assert (plan.key.backend, plan.key.fuse) == ("conv", "levels")
    pa = plan.execute(x)
    pm = R.dwt2(x, levels=2, backend="conv", fuse="levels", device="cpu")
    assert torch.equal(pa.ll, pm.ll)


def test_auto_never_resolves_float64_to_cuda(store):
    key = dataclasses.replace(_key(), dtype="float64")
    store.extend([_rec(dataclasses.replace(key, dtype="float32"), "cuda",
                       "pyramid", 1e-9)])
    plan = TE.get_plan(shape=(2, 32, 32), levels=2, backend="auto",
                       dtype="float64", device="cpu", cache=TE.PlanCache())
    assert plan.key.backend != "cuda" and plan.key.dtype == "float64"
    out = plan.execute(_x((2, 32, 32)).double())
    assert out.ll.dtype == torch.float64


def test_auto_cache_key_stays_auto(store):
    """Repeated auto traffic hits the plan cache under the *auto* key —
    the resolution is not re-run per call."""
    cache = TE.PlanCache()
    before = dict(PA.AUTO_COUNTERS)
    p1 = TE.get_plan(shape=(2, 32, 32), levels=2, backend="auto",
                     device="cpu", cache=cache)
    p2 = TE.get_plan(shape=(2, 32, 32), levels=2, backend="auto",
                     device="cpu", cache=cache)
    assert p2 is p1
    assert cache.stats() == {"hits": 1, "misses": 1, "size": 1,
                             "maxsize": cache.maxsize}
    (cached,) = cache._plans
    assert cached.backend == "auto" and p1.key.backend == "torch"
    delta = sum(PA.AUTO_COUNTERS.values()) - sum(before.values())
    assert delta == 1                      # one resolution, not two


def test_auto_backend_never_executes_directly():
    bk = TB.get_backend("auto")
    with pytest.raises(ValueError):
        bk.make_forward(None)
    assert TB.UNPORTED_BACKENDS == ()


def test_stats_surfaces_auto_and_block_table():
    R.dwt2(_x((2, 32, 32)), levels=2, backend="auto", device="cpu")
    s = TE.stats()
    assert sorted(s["auto"]) == ["choices", "cold_fallbacks",
                                 "predictions", "store_hits"]
    assert s["auto"]["cold_fallbacks"] == 1
    assert s["auto"]["choices"] == {"torch|levels": 1}
    assert "device_fallbacks" in s["block_table"]
    assert any(r["backend"] == "auto" for r in s["backends"])
    (row,) = [r for r in s["plans"] if "auto" in r]
    assert row["backend"] == "auto"
    assert row["auto"] == {"backend": "torch", "fuse": "levels",
                           "tap_opt": "full", "source": "heuristic",
                           "predicted_s": None}
    # the same keys as the reference's sections
    js = JE.stats()
    assert sorted(s["auto"]) == sorted(js["auto"])
    assert sorted(s["block_table"]) == sorted(js["block_table"])
    assert sorted(s["serve"]) == sorted(js["serve"])


# ---------------------------------------------------------------------------
# the tracer: measurements, records, warmed stores, the model ratio
# ---------------------------------------------------------------------------

def test_warm_store_measures_every_candidate_and_auto_follows(store):
    recs = PF.warm_store(shape=(1, 16, 16), levels=1, reps=1, device="cpu")
    assert [(r.backend, r.fuse) for r in recs] == [
        (b, f) for b, f, _ in PF.enumerate_candidates(
            _key(shape=(1, 16, 16), levels=1))]
    assert len(store.records("cpu:cpu")) == len(recs)
    for r in recs:
        assert r.time_s > 0 and r.meta["plain_kernels"] is True
        assert r.meta["fingerprint"] == "cpu:cpu"
        assert r.meta["reps"] == 1 and r.meta["spread"] == 0.0
        assert r.block == (TW.BLOCK_TARGET if r.backend == "cuda" else None)
    best = min(recs, key=lambda r: (r.time_s, r.backend, r.fuse))
    plan = TE.get_plan(shape=(1, 16, 16), levels=1, backend="auto",
                       device="cpu", cache=TE.PlanCache())
    assert plan.auto.source == "store"
    assert (plan.key.backend, plan.key.fuse) == (best.backend, best.fuse)
    # warm_batches: one record per candidate and batch size
    more = PF.warm_batches([1, 2], (16, 16), levels=1, reps=1,
                           device="cpu",
                           candidates=[("torch", "levels", "full")])
    assert [r.shape for r in more] == [(1, 16, 16), (2, 16, 16)]


def test_profile_plan_feeds_the_model_time_ratio(store):
    """A plan resolved by the model carries its prediction; profiling it
    publishes measured / predicted as repro_model_time_ratio."""
    for shape in ((1, 16, 16), (1, 32, 32), (1, 64, 64)):
        PF.warm_store(shape=shape, levels=1, reps=1, device="cpu",
                      candidates=[("torch", "levels", "full")])
    plan = TE.get_plan(shape=(1, 48, 48), levels=1, backend="auto",
                       device="cpu", cache=TE.PlanCache())
    assert plan.auto.source == "model" and plan.auto.predicted_s > 0
    rec = PF.profile_plan(plan, reps=1, record=False)
    rows = [r for r in T.roofline() if r["op"] == "profile"]
    (row,) = rows
    assert row["model_time_ratio"] == pytest.approx(
        rec.time_s / plan.auto.predicted_s)
    assert len(store.records()) == 3            # record=False wrote none


def test_runtime_meta_names_the_stack():
    meta = PF.runtime_meta("cpu")
    assert meta["fingerprint"] == "cpu:cpu" and meta["plain_kernels"]
    assert meta["torch_version"] == torch.__version__
    assert meta["cuda_version"] == torch.version.cuda
    assert {"device_kind", "platform", "python_version"} <= set(meta)


# ---------------------------------------------------------------------------
# store durability: choose() over a torn/garbage tail
# ---------------------------------------------------------------------------

def test_choose_survives_truncated_store_tail(store):
    key = _key()
    store.extend([_rec(key, "torch", "levels", 3e-3),
                  _rec(key, "conv", "levels", 1e-3)])
    with open(store.path, "a") as f:
        f.write('{"v": 1, "backend": "cuda", "time_s": 1e-9, "tr\n')
        f.write("not json at all\n")
    before = sum(s["value"] for s in PST.CORRUPT_RECORDS.series())
    reread = PF.TraceStore(store.path)
    assert len(reread.records()) == 2      # valid prefix only
    choice = PF.choose(key, store=reread)
    assert choice.source == "store"
    assert (choice.backend, choice.fuse) == ("conv", "levels")
    assert sum(s["value"] for s in PST.CORRUPT_RECORDS.series()) == \
        before + 2


def test_store_fault_sites_fire():
    from repro_torch.faults import plan as FP
    store = PF.TraceStore()
    PFJ.activate(FP.FaultPlan.from_text("profiler.store_write=once"))
    with pytest.raises(PFJ.InjectedFault):
        store.append(_rec(_key(), "torch", "levels", 1e-3))
    store.append(_rec(_key(), "torch", "levels", 1e-3))
    PFJ.activate(FP.FaultPlan.from_text("profiler.store_read=once"))
    with pytest.raises(PFJ.InjectedFault):
        PF.TraceStore().records()
    PFJ.activate(None)
    assert len(PF.TraceStore().records()) == 1
