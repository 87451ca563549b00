"""The port's multi-tenant serving protocol against the JAX package's, on
the CPU.

The interleave (float64 virtual times, lexsort) must give the JAX
package's order for every policy, tenant count and rate; ``tenant_shift``
and ``shared_llc_pass`` (one K1 pass over the merged, tenant-shifted
stream; its plain version here) the JAX package's shifts and hit masks;
``shared_table_streams`` the same streams and contention counters over the
same traces.  Serve specs through ``repro_torch.core.Experiment(device=
"cpu")`` must give the JAX package's rows exactly, including the
``tenant`` / ``table_mode`` columns and ``info["serve"]``, serially and
under ``workers=2``; with one tenant every row equals the plain grid row;
and the contention document ``chip_smoke.py`` builds must equal the one
``examples/serving_contention.py --tiny`` writes.
"""
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core as jcore
import repro.serve as jserve
import repro_torch.core as tcore
import repro_torch.serve as tserve
from repro.memsim import engine as jengine
from repro.memsim import shared_llc as jllc
from repro_torch.memsim import engine as tengine
from repro_torch.memsim import shared_llc as tllc

ROOT = Path(__file__).resolve().parents[1]
TWO = ["amc", "nextline2"]


def jsonable(x):
    return json.loads(json.dumps(x, default=lambda o: o.tolist()))


def lengths(k, seed):
    rng = np.random.default_rng(seed)
    out = rng.integers(0, 400, size=k).tolist()
    out[0] = max(out[0], 1)
    return out


@pytest.mark.parametrize("policy,k,rates", [
    ("round_robin", 1, None),
    ("round_robin", 2, None),
    ("round_robin", 3, (5.0, 1.0, 0.5)),  # round_robin ignores rates
    ("round_robin", 6, None),
    ("rate", 2, (1.0, 2.0)),
    ("rate", 3, (0.3, 1.7, 2.5)),
    ("rate", 3, (1 / 3, 3.0, 1.0)),
    ("rate", 4, (1.0, 1.0, 1e-3, 7.25)),
    ("rate", 2, None),  # no rates: every tenant at 1
])
@pytest.mark.parametrize("seed", [0, 1])
def test_interleave_equals_jax(policy, k, rates, seed):
    n = lengths(k, seed)
    jil = jserve.interleave(n, rates=rates, policy=policy)
    til = tserve.interleave(n, rates=rates, policy=policy)
    assert til.policy == jil.policy and til.num_tenants == k and til.total == sum(n)
    np.testing.assert_array_equal(til.rates, jil.rates)
    assert til.tenant_of.dtype == jil.tenant_of.dtype
    np.testing.assert_array_equal(til.tenant_of, jil.tenant_of)
    for tg, jg, td in zip(til.gmaps, jil.gmaps, tserve.deinterleave(til), strict=True):
        assert tg.dtype == jg.dtype == td.dtype
        np.testing.assert_array_equal(tg, jg)
        np.testing.assert_array_equal(td, tg)  # the roundtrip


@pytest.mark.parametrize("args", [
    dict(lengths=[3], policy="chaos"),
    dict(lengths=[]),
    dict(lengths=[3, 4], rates=[1.0], policy="rate"),
    dict(lengths=[3, 4], rates=[1.0, 0.0], policy="rate"),
    dict(lengths=[3, 4], rates=[1.0, float("inf")], policy="rate"),
])
def test_interleave_validation_equals_jax(args):
    errs = []
    for pkg in (jserve, tserve):
        with pytest.raises(ValueError) as info:
            pkg.interleave(**args)
        errs.append(str(info.value))
    assert errs[0] == errs[1]


@pytest.mark.parametrize("max_block,sets", [(1000, 64), (3, 64), (10**6, 1), (63, 64),
                                            (0, 2), (2**20, 4096)])
def test_tenant_shift(max_block, sets):
    shift = tllc.tenant_shift(max_block, sets)
    assert shift == jllc.tenant_shift(max_block, sets)
    assert (1 << shift) > max_block  # namespaces disjoint
    for k in range(4):
        assert (k << shift) % max(sets, 1) == 0  # set index preserved


def _tenant_streams(k, seed, spread=300):
    """K seeded LLC-input streams with interleaved keys as ``_share_llc``
    makes them: doubled positions mapped through the interleave."""
    rng = np.random.default_rng(seed)
    n = [int(rng.integers(1, 900)) for _ in range(k)]
    il = jserve.interleave(n)
    streams = []
    for t in range(k):
        blocks = rng.integers(0, spread, size=n[t]).astype(np.int64)
        pos2 = 2 * np.arange(n[t]) + rng.integers(0, 2, size=n[t])
        streams.append((blocks, 2 * il.gmaps[t][pos2 // 2] + (pos2 & 1)))
    return streams


@pytest.mark.parametrize("k", [1, 2, 3, 5])
@pytest.mark.parametrize("sets,ways", [(64, 8), (16, 2), (1, 4)])
def test_shared_llc_pass_equals_jax(k, sets, ways):
    streams = _tenant_streams(k, seed=10 * k + sets)
    got = tllc.shared_llc_pass(streams, sets, ways, device="cpu")
    want = jllc.shared_llc_pass(streams, sets, ways)
    for g, w, (b, _) in zip(got, want, streams, strict=True):
        assert g.dtype == w.dtype == bool and len(g) == len(b)
        np.testing.assert_array_equal(g, w)
    if k == 1:  # the K=1 anchor: the private pass itself
        np.testing.assert_array_equal(got[0], tengine.cache_pass(streams[0][0], sets, ways,
                                                                 device="cpu"))
    for g, (b, _) in zip(got, streams):  # contention only loses hits
        assert not np.any(g & ~jengine.cache_pass(b, sets, ways))


def test_shared_llc_namespace_overflow_equals_jax():
    big = np.array([2**30], dtype=np.int64)
    streams = [(big, np.array([0])), (big, np.array([1]))]
    errs = []
    for fn in (jllc.shared_llc_pass, tllc.shared_llc_pass):
        with pytest.raises(ValueError) as info:
            fn(streams, 64, 4)
        errs.append(str(info.value))
    assert errs[0] == errs[1] and "overflows int32" in errs[1]
    assert tllc.shared_llc_pass([(np.zeros(0, np.int64), np.zeros(0, np.int64))], 64, 4,
                                device="cpu")[0].shape == (0,)


@pytest.fixture(scope="module")
def caches():
    """One workload cache a package: tenant traces are ordinary workloads.
    The port's is shared by every scenario below; the JAX package scores
    each scenario from a fresh one (see ``_run``)."""
    return jcore.WorkloadCache(), tcore.WorkloadCache()


def _serve(pkg, tenants, **kw):
    return pkg.ServeSpec(tenants=tuple(pkg.TenantSpec(*t) for t in tenants), **kw)


def _run(caches, tenants, prefetchers=TWO, **kw):
    # The JAX package caches a baseline's cycles on the profile under the
    # baseline outcome's id(): a second scenario scored on the same trace
    # objects can read a freed contended baseline's entry.  So each JAX
    # scenario builds its own traces; the port's shared cache holds
    # (``test_baseline_cycles_follow_the_baseline_outcome``).
    jres = jcore.Experiment(workloads=[_serve(jserve, tenants, **kw)], prefetchers=prefetchers,
                            cache=jcore.WorkloadCache()).run(workers=1)
    tres = tcore.Experiment(workloads=[_serve(tserve, tenants, **kw)], prefetchers=prefetchers,
                            cache=caches[1], device="cpu").run(workers=1)
    return jres, tres


def test_shared_table_streams_equal_jax(caches):
    """Both packages' shared-table walks over the JAX package's traces."""
    from repro.core.amc.prefetcher import AMCConfig as JConfig, AMCPrefetcher as JAMC
    from repro_torch.core.amc.prefetcher import AMCConfig as TConfig, AMCPrefetcher as TAMC

    traces = [caches[0].get_or_build(jcore.WorkloadSpec(k, "tiny", seed=s))
              for k, s in (("pgd", 0), ("cc", 0), ("pgd", 1))]
    n = [t.num_accesses for t in traces]
    got = []
    for pkg, amc in ((jserve, JAMC(JConfig())), (tserve, TAMC(TConfig()))):
        streams, counters = pkg.shared_table_streams(amc, traces, pkg.interleave(n))
        got.append((jsonable([(s.name, s.blocks, s.pos, s.metadata_bytes, s.info)
                              for s in streams]), counters))
    assert got[0] == got[1]
    counters = got[1][1]
    assert counters["cross_tenant_overwrites"] > 0 and counters["aliased_hits"] > 0
    assert [sorted(t) for t in counters["per_tenant"]] == [
        ["aliased_hits", "lookup_hits", "lookups", "recordings_evicted"]] * 3


@pytest.mark.parametrize("tenants,kw", [
    ([("pgd", "tiny", 0), ("cc", "tiny", 0)], {}),
    ([("pgd", "tiny", 0), ("cc", "tiny", 0), ("pgd", "tiny", 1)], {}),
    ([("cc", "tiny", 0, 1.0), ("pgd", "tiny", 1, 2.5), ("pgd", "tiny", 0, 0.5)],
     dict(policy="rate", table_modes=("shared",))),
], ids=["K2", "K3", "K3-rate-shared"])
def test_serve_through_experiment_equals_jax(caches, tenants, kw):
    jres, tres = _run(caches, tenants, **kw)
    rows = jsonable(tres.rows())
    assert rows == jsonable(jres.rows())
    modes = kw.get("table_modes", ("per_tenant", "shared"))
    assert [(r["prefetcher"], r["table_mode"], r["tenant"]) for r in rows] == [
        (p, m, t) for p, ms in (("amc", modes), ("nextline2", (None,)))
        for m in ms for t in range(len(tenants))]
    for r in rows:
        assert r["info"]["serve"]["tenant"] == r["tenant"]
        assert ("shared_table" in r["info"]["serve"]) == (r["table_mode"] == "shared")
    assert set(tres.workloads) == {tcore.WorkloadSpec(t[0], t[1], seed=t[2]) for t in tenants}


def test_baseline_cycles_follow_the_baseline_outcome(caches):
    """``evaluate`` keeps a baseline's cycles on that outcome: baselines
    made and freed one after another against one profile, as serving's
    contended baselines are, each score as on a profile never scored."""
    import dataclasses

    from repro_torch.memsim import evaluate

    w = caches[1].get_or_build(tcore.WorkloadSpec("pgd", "tiny"), device="cpu")
    rng = np.random.default_rng(0)
    speedups = []
    for i in range(12):
        fresh = dataclasses.replace(w.profile)  # no cached timings
        hit = w.nl_outcome.demand_llc_hit.copy()
        hit[rng.random(len(hit)) < 0.04 * i] = False  # a contended baseline
        base = dataclasses.replace(w.nl_outcome, demand_llc_hit=hit,
                                   metadata_bytes=i << 18)
        want = evaluate("x", fresh, w.nl_outcome, baseline_outcome=base, issuer=0).speedup
        speedups.append(evaluate("x", w.profile, w.nl_outcome, baseline_outcome=base,
                                 issuer=0).speedup)
        assert speedups[-1] == want, i
        del base, fresh  # freed: the next baseline may take the same id
    assert len(set(speedups)) == 12


def test_k1_serving_byte_identical_to_grid(caches):
    """One tenant: identity interleave, zero-offset LLC namespace, no foreign
    table owner — every serving row, stripped of its serving fields, is the
    plain grid row; and both equal the JAX package's."""
    jres, tres = _run(caches, [("pgd", "tiny", 0)])
    assert jsonable(tres.rows()) == jsonable(jres.rows())
    plain = tcore.Experiment(workloads=[tcore.WorkloadSpec("pgd", "tiny")], prefetchers=TWO,
                             cache=caches[1], device="cpu").run(workers=1)
    by_pf = {r["prefetcher"]: r for r in jsonable(plain.rows())}
    rows = jsonable(tres.rows())
    assert {r["table_mode"] for r in rows} == {"per_tenant", "shared", None}
    for row in rows:
        row.pop("tenant"), row.pop("table_mode")
        assert row["info"].pop("serve")["llc_demand_hits_lost"] == 0
        assert row == by_pf[row["prefetcher"]]


def test_contention_document_equals_the_example(caches, tmp_path):
    """``chip_smoke.contention_document`` on the port's run equals the
    document ``examples/serving_contention.py --tiny`` writes through the
    JAX package; ``contention_payload`` is held through it."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    out = tmp_path / "contention.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               HOME=str(tmp_path))
    subprocess.run([sys.executable, str(ROOT / "examples" / "serving_contention.py"), "--tiny",
                    "--out", str(out)], cwd=tmp_path, env=env, check=True,
                   capture_output=True)
    spec = _serve(tserve, [("pgd", "tiny", 0), ("cc", "tiny", 0), ("pgd", "tiny", 1)])
    res = tcore.Experiment(workloads=[spec], prefetchers=TWO, cache=caches[1],
                           device="cpu").run(workers=1)
    doc = jsonable(chip_smoke.contention_document(res, spec))
    assert doc == json.loads(out.read_text())
    assert doc["schema"] == "serve-contention" and set(doc["prefetchers"]["amc"]) == {
        "per_tenant", "shared"}


def test_serve_spec_validation_equals_jax():
    def cases(pkg):
        t = pkg.TenantSpec("pgd", "tiny")
        return [lambda: pkg.ServeSpec(tenants=()),
                lambda: pkg.ServeSpec(tenants=(t,), policy="chaos"),
                lambda: pkg.ServeSpec(tenants=(t,), table_modes=("global",)),
                lambda: pkg.ServeSpec(tenants=(t,), table_modes=()),
                lambda: pkg.ServeSpec(tenants=("pgd",)),
                lambda: pkg.TenantSpec("pgd", "tiny", rate=0.0)]

    for jcase, tcase in zip(cases(jserve), cases(tserve), strict=True):
        errs = []
        for case in (jcase, tcase):
            with pytest.raises((ValueError, TypeError)) as info:
                case()
            errs.append((type(info.value), str(info.value)))
        assert errs[0] == errs[1]
    with pytest.raises(ValueError, match="unknown dataset"):
        tcore.Experiment(workloads=[_serve(tserve, [("pgd", "nope")])], device="cpu")


def test_serve_parallel_equals_serial():
    """``workers=2`` builds the tenants in spawned CPU workers and scores
    here: the rows equal the serial run's."""
    spec = _serve(tserve, [("bfs", "tiny", 0), ("bfs", "tiny", 1), ("bellmanford", "tiny", 0)])
    with tempfile.TemporaryDirectory() as tmp:
        rows = {}
        for w in (1, 2):
            cache = tcore.WorkloadCache(artifacts=tcore.ArtifactCache(Path(tmp) / f"w{w}"))
            res = tcore.Experiment(workloads=[spec], prefetchers=TWO, cache=cache,
                                   device="cpu").run(workers=w)
            rows[w] = jsonable(res.rows())
            assert cache.builds == (3 if w == 1 else 0)
    assert rows[1] == rows[2] and len(rows[1]) == 9
