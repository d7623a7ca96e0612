"""The port's autotuner (repro_torch.tune) against the JAX reference's
(repro.tune), on the CPU:

  * the search space proposes the reference's point sequence for equal
    seeds (``TrialPoint.key()`` strings), sync and straggler workloads;
  * ``tune()`` with the same analytic runner in both packages gives the
    same ``trials`` and ``best`` (only ``host``, ``key`` and ``provenance``
    differ), and the ``--dry`` CLI prints the same winner;
  * ``record_key`` is the reference's function; the port's records carry
    their own schema, keyed by the device the trials run on, in their own
    directory; the reference's record tests as plain parametrised cases;
  * ``engine_config_kwargs`` builds the port's counterpart of every
    reference object;
  * measured CPU trials: uplink bytes exactly the reference's, staleness
    and the arrival-age counts to one float32 ulp (the reference's clock
    draws replayed through ``repro_torch.interop.clock_draws``), and the
    objective from the snapshot;
  * ``launch.train --autotune`` adopts a record's point into the same
    engine configuration as the reference's block.
"""
import dataclasses
import json
import os
from pathlib import Path

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import repro.tune as jtune_pkg  # noqa: E402
import repro_torch.tune as tune_pkg  # noqa: E402
from repro import sched as jsched  # noqa: E402
from repro.obs.metrics import MetricsRegistry as JMetricsRegistry  # noqa: E402
from repro.tune import __main__ as jtune_main  # noqa: E402
from repro.tune import records as jrecords  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.obs.metrics import MetricsRegistry  # noqa: E402
from repro_torch.tune import (SCHEMA, SearchSpace, TrialPoint,  # noqa: E402
                              TrialRunner, Workload, engine_config_kwargs,
                              load_record, record_key, record_path,
                              save_record, tune, validate_record)
from repro_torch.tune import __main__ as tune_main  # noqa: E402
from repro_torch.tune import records  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
REF_RECORD = ROOT / "experiments" / "tune" / "tune_3e161f2b1ac6401f.json"

WORKLOADS = {"sync": dict(), "straggler": dict(clock="straggler")}


def _pair(name):
    return (Workload(**WORKLOADS[name]),
            jtune_pkg.Workload(**WORKLOADS[name]))


# ---------------------------------------------------------------------------
# the search space and the search
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_proposals_are_the_references(seed, name):
    w, jw = _pair(name)
    space, jspace = SearchSpace(), jtune_pkg.SearchSpace()
    assert space.signature() == jspace.signature()
    rng, jrng = np.random.default_rng(seed), np.random.default_rng(seed)
    got = [p.key() for p in space.initial_candidates(6, rng, w)]
    ref = [p.key() for p in jspace.initial_candidates(6, jrng, jw)]
    assert got == ref and len(got) == 6
    for _ in range(4):
        got.append(space.sample(rng, w).key())
        ref.append(jspace.sample(jrng, jw).key())
    for key in list(got):
        p = TrialPoint.from_dict(json.loads(key))
        got += [q.key() for q in space.neighbors(p, rng, w, tries=8)]
        ref += [q.key() for q in jspace.neighbors(
            jtune_pkg.TrialPoint.from_dict(json.loads(key)), jrng, jw,
            tries=8)]
    assert got == ref
    assert space.default_point(w).key() == jspace.default_point(jw).key()


def _fake(runner_cls, registry_cls):
    """The reference test's analytic runner, for either package."""

    class FakeRunner(runner_cls):
        def __init__(self, workload, rounds=16):
            super().__init__(workload, rounds=rounds)
            self.sequence = []

        def measure(self, point):
            self.measured_trials += 1
            self.sequence.append((point.key(), self.rounds))
            registry = registry_cls()
            registry.gauge("tune/round_us").set(
                100.0 + 50.0 / point.chunk_rounds
                + (5.0 if point.transport != "dense" else 0.0)
                + (3.0 if point.plane else 0.0))
            registry.gauge("tune/bytes_per_client_round").set(
                168.0 * (point.ratio if point.transport != "dense"
                         else 1.0))
            registry.gauge("tune/staleness_mean").set(
                0.5 * point.queue_depth)
            return self.score(point, registry.snapshot())

    return FakeRunner


FakeRunner = _fake(TrialRunner, MetricsRegistry)
JFakeRunner = _fake(jtune_pkg.TrialRunner, JMetricsRegistry)
DIFFERING = ("host", "key", "provenance", "path")


@pytest.mark.parametrize("seed,budget", [(0, 6), (3, 10), (7, 8), (11, 1)])
@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_search_record_is_the_references(seed, budget, name, tmp_path):
    w, jw = _pair(name)
    runner, jrunner = FakeRunner(w), JFakeRunner(jw)
    rec = tune(w, budget=budget, seed=seed, runner=runner,
               cache_dir=str(tmp_path / "port"), device="cpu")
    jrec = jtune_pkg.tune(jw, budget=budget, seed=seed, runner=jrunner,
                          cache_dir=str(tmp_path / "ref"))
    assert runner.sequence == jrunner.sequence
    assert rec["trials"] == jrec["trials"] and rec["best"] == jrec["best"]
    assert ({k: v for k, v in rec.items() if k not in DIFFERING}
            == {k: v for k, v in jrec.items() if k not in DIFFERING})
    # the hillclimb may stop short of the budget in a small neighbourhood
    assert rec["measured_trials"] == runner.measured_trials <= budget
    # the port's record is its own: another schema, another directory
    saved = json.loads(Path(rec["path"]).read_text())
    assert saved["schema"] == SCHEMA != jrecords.SCHEMA
    assert Path(rec["path"]).parent == tmp_path / "port"
    # a second call answers from the record with zero measured trials
    again = FakeRunner(w)
    hit = tune(w, budget=budget, seed=seed, runner=again,
               cache_dir=str(tmp_path / "port"), device="cpu")
    assert again.measured_trials == 0 and hit["cached"]
    assert hit["measured_trials"] == 0 and hit["best"] == rec["best"]


@pytest.mark.parametrize("extra", [[], ["--async"], ["--budget", "7",
                                                     "--seed", "4"]])
def test_dry_cli_prints_the_references_winner(extra, capsys):
    assert tune_main.main(["--device", "cpu", "--budget", "3", "--dry"]
                          + extra) == 0
    mine = capsys.readouterr().out
    assert jtune_main.main(["--budget", "3", "--dry"] + extra) == 0
    assert mine == capsys.readouterr().out
    assert "winner: " in mine


def test_search_default_cache_is_the_ports_own(tmp_path, monkeypatch):
    """With no ``cache_dir`` the record goes to experiments/tune_torch/,
    never next to the reference's committed record."""
    monkeypatch.chdir(tmp_path)
    w = Workload()
    rec = tune(w, budget=2, runner=FakeRunner(w), device="cpu")
    assert Path(rec["path"]).parent == Path("experiments", "tune_torch")
    assert records.DEFAULT_CACHE_DIR != jrecords.DEFAULT_CACHE_DIR
    assert not (tmp_path / "experiments" / "tune").exists()


# ---------------------------------------------------------------------------
# records
# ---------------------------------------------------------------------------

HOSTILE_HOST = {"hostname": "../../etc/passwd", "backend": "cpu",
                "device_kind": "weird/device é", "torch_version": "9.9",
                "cuda_version": None, "x64": True}
HOSTILE_WSIG = {"kind": "logreg", "note": "a b/c\\d.json"}


@pytest.mark.parametrize("host,wsig,ssig", [
    (HOSTILE_HOST, HOSTILE_WSIG, {"ratio": [0.1, 0.25]}),
    ({"hostname": "h", "backend": "cuda", "x64": False},
     Workload().signature(), SearchSpace().signature()),
    ({}, {}, {}),
    ({"b": 1, "a": [1, 2, {"z": None}]}, {"é": "ü"}, {"x": 1.5}),
])
def test_record_key_is_the_references(host, wsig, ssig):
    assert record_key(host, wsig, ssig) == jrecords.record_key(host, wsig,
                                                               ssig)


def _record(host, wsig, ssig):
    key = record_key(host, wsig, ssig)
    point = TrialPoint().to_dict()
    return {"key": key, "host": host, "workload": wsig, "space": ssig,
            "budget": 4, "rounds": 16, "seed": 0,
            "best": {"point": point, "objective": 123.4, "round_us": 110.0,
                     "bytes_per_client_round": 168.0,
                     "staleness_mean": 0.0, "rounds": 16},
            "trials": [{"point": point, "objective": 123.4,
                        "round_us": 110.0,
                        "bytes_per_client_round": 168.0}]}


def _case_hostile_keys(tmp_path):
    # path separators, dots, spaces, unicode: none of it may reach the
    # filesystem name, all of it must round-trip
    ssig = {"ratio": [0.1, 0.25]}
    rec = _record(HOSTILE_HOST, HOSTILE_WSIG, ssig)
    path = save_record(rec, str(tmp_path))
    assert os.path.dirname(path) == str(tmp_path)
    assert os.path.basename(path) == f"tune_{rec['key'][:16]}.json"
    loaded = load_record(rec["key"], str(tmp_path), host=HOSTILE_HOST,
                         workload_sig=HOSTILE_WSIG, space_sig=ssig)
    assert loaded is not None and loaded["schema"] == SCHEMA
    assert loaded["host"] == HOSTILE_HOST
    assert loaded["best"]["objective"] == pytest.approx(123.4)
    for field in records.PROVENANCE_FIELDS:
        assert field in loaded["provenance"]
    assert loaded["provenance"]["torch_version"] == torch.__version__
    assert loaded["provenance"]["device_kind"] == "weird/device é"
    assert validate_record(loaded) == []


def _case_mismatch(tmp_path):
    host = records.host_signature("cpu")
    rec = _record(host, Workload().signature(), SearchSpace().signature())
    save_record(rec, str(tmp_path))
    key = rec["key"]
    assert load_record(key, str(tmp_path)) is not None
    other = Workload(n_clients=99).signature()
    assert load_record(key, str(tmp_path), workload_sig=other) is None
    assert load_record(key, str(tmp_path), space_sig=SearchSpace(
        plane=(True,)).signature()) is None
    assert load_record(key, str(tmp_path), host=dict(
        host, device_kind="NVIDIA H100 80GB HBM3")) is None
    assert load_record("f" * 64, str(tmp_path)) is None


def _case_corruption(tmp_path):
    rec = _record(records.host_signature("cpu"), Workload().signature(),
                  SearchSpace().signature())
    save_record(rec, str(tmp_path))
    key = rec["key"]
    path = record_path(key, str(tmp_path))
    edited = json.loads(Path(path).read_text())
    edited["workload"] = {"kind": "tampered"}
    Path(path).write_text(json.dumps(edited))
    assert load_record(key, str(tmp_path)) is None
    Path(path).write_text('{"schema": "repro_torch.tune.record/v1", "key"')
    assert load_record(key, str(tmp_path)) is None
    Path(path).write_text("[1, 2]")
    assert load_record(key, str(tmp_path)) is None


def _case_validate(tmp_path):
    rec = _record(records.host_signature("cpu"), Workload().signature(),
                  SearchSpace().signature())
    rec["schema"] = SCHEMA
    rec["provenance"] = records.provenance(rec["host"])
    assert validate_record(rec) == []
    assert any("schema" in e for e in validate_record({**rec,
                                                       "schema": "v0"}))
    bad = dict(rec)
    del bad["trials"]
    assert any("trials" in e for e in validate_record(bad))
    assert any("key" in e for e in validate_record({**rec,
                                                    "key": "0" * 64}))
    assert any("provenance missing 'torch_version'" == e
               for e in validate_record({**rec, "provenance": {
                   k: v for k, v in rec["provenance"].items()
                   if k != "torch_version"}}))
    assert any("trials[0] missing 'round_us'" == e for e in validate_record(
        {**rec, "trials": [{"point": {}, "objective": 1.0,
                            "bytes_per_client_round": 1.0}]}))


@pytest.mark.parametrize("case", ["hostile_keys", "mismatch", "corruption",
                                  "validate"])
def test_records(case, tmp_path):
    globals()[f"_case_{case}"](tmp_path)


def test_the_references_record_is_foreign_and_left_alone(capsys):
    before = REF_RECORD.read_bytes()
    ref = json.loads(before)
    errors = validate_record(ref)
    assert errors and "foreign" in errors[0]
    assert jrecords.validate_record(ref) == []
    assert tune_main.main(["--validate", str(REF_RECORD)]) == 1
    out = capsys.readouterr().out
    assert "INVALID" in out and "foreign" in out
    assert REF_RECORD.read_bytes() == before


def test_cpu_and_card_searches_never_share_a_key(monkeypatch):
    cpu = records.host_signature("cpu")
    assert (cpu["backend"], cpu["device_kind"]) == ("cpu", "cpu")
    assert set(cpu) == {"hostname", "backend", "device_kind",
                        "torch_version", "cuda_version", "x64"}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA H100 80GB HBM3")
    card = records.host_signature("cuda")
    assert (card["backend"], card["device_kind"]) == (
        "cuda", "NVIDIA H100 80GB HBM3")
    w, s = Workload().signature(), SearchSpace().signature()
    assert record_key(cpu, w, s) != record_key(card, w, s)
    assert records.host_signature(None) == card
    assert records.host_signature("cpu", x64=False) != cpu


# ---------------------------------------------------------------------------
# engine configurations
# ---------------------------------------------------------------------------


def _match(a, b) -> bool:
    """Two packages' objects agree: the same class name and, field by
    field (the union of both dataclasses' fields, read as attributes), the
    same values all the way down."""
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        names = {f.name for f in dataclasses.fields(a)} | {
            f.name for f in dataclasses.fields(b)}
        return type(a).__name__ == type(b).__name__ and all(
            _match(getattr(a, n), getattr(b, n)) for n in sorted(names))
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(map(_match, a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_match(a[k], b[k]) for k in a)
    return type(a) is type(b) and a == b


POINTS = [
    dict(),
    dict(chunk_rounds=4, plane=True),
    dict(transport="topk", ratio=0.1, granularity="global"),
    dict(transport="topk", ratio=0.25, schedule="linear", plane=True),
    dict(transport="topk", ratio=0.5, schedule="bucketed",
         granularity="global"),
    dict(transport="randk", ratio=0.25),
    dict(transport="quantize", granularity="global"),
    dict(chunk_rounds=8, transport="topk", ratio=0.25, granularity="global",
         plane=True, buffer_frac=0.5, queue_depth=2, staleness="poly",
         schedule="linear"),
    dict(transport="quantize", buffer_frac=0.5, staleness="poly"),
]


@pytest.mark.parametrize("point", POINTS, ids=lambda p: TrialPoint(
    **p).describe())
@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_engine_config_kwargs_builds_the_references_objects(point, name):
    w, jw = _pair(name)
    kw = engine_config_kwargs(TrialPoint(**point), w)
    jkw = jtune_pkg.engine_config_kwargs(jtune_pkg.TrialPoint(**point), jw)
    assert _match(kw, jkw)
    if name == "straggler":
        assert {"clock", "buffer_size", "staleness"} <= set(kw)
    else:
        assert "clock" not in kw


# ---------------------------------------------------------------------------
# measured trials on the CPU
# ---------------------------------------------------------------------------

SMALL = dict(n_clients=6, m_per_client=20, dim=10)


def _ref_clock_draws(clock, commits: int, n: int):
    """The reference engine's clock draws (key ``clock_seed`` = 0, split
    per commit), replayed in the port."""
    key = jax.random.PRNGKey(0)
    normals, bern = [], []
    for _ in range(commits):
        key, ksub = jax.random.split(key)
        k_jit, k_mix = jax.random.split(ksub)
        normals.append(np.asarray(jax.random.normal(k_jit, (n,),
                                                    jnp.float32)))
        bern.append(np.asarray(jax.random.bernoulli(
            k_mix, clock.straggler_frac, (n,))))
    return interop.clock_draws(
        normals, None if getattr(clock, "persistent", True) else bern)


class ReplayingRunner(TrialRunner):
    """The port's runner with the reference's clock draws."""

    def _clock_draws(self):
        if not self.workload.is_async:
            return None
        w = self.workload
        clock = jsched.StragglerClock(straggler_frac=w.straggler_frac,
                                      slowdown=w.slowdown)
        return _ref_clock_draws(clock, 64, w.n_clients)


TRIALS = {
    "dense": ("sync", dict(chunk_rounds=4)),
    "topk_leaf": ("sync", dict(chunk_rounds=4, transport="topk",
                               ratio=0.25)),
    "topk_global": ("sync", dict(chunk_rounds=8, transport="topk",
                                 ratio=0.1, granularity="global")),
    "plane": ("sync", dict(chunk_rounds=4, transport="topk", ratio=0.5,
                           granularity="global", plane=True)),
    "async": ("straggler", dict(chunk_rounds=4, transport="topk",
                                ratio=0.25, plane=True, buffer_frac=0.5,
                                queue_depth=2, staleness="poly",
                                schedule="linear")),
}


@pytest.mark.parametrize("trial", sorted(TRIALS))
def test_measured_trial_is_the_references(trial):
    name, point = TRIALS[trial]
    w = Workload(**dict(SMALL, **WORKLOADS[name]))
    jw = jtune_pkg.Workload(**dict(SMALL, **WORKLOADS[name]))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        runner = ReplayingRunner(w, rounds=8, reps=1, device="cpu")
        res = runner.measure(TrialPoint(**point))
    finally:
        torch.set_num_threads(threads)
    jrunner = jtune_pkg.TrialRunner(jw, rounds=8, reps=1)
    ref = jrunner.measure(jtune_pkg.TrialPoint(**point))
    assert runner.measured_trials == 1 and res.round_us > 0
    assert res.bytes_per_client_round == ref.bytes_per_client_round
    np.testing.assert_array_max_ulp(np.float32(res.staleness_mean),
                                    np.float32(ref.staleness_mean), 1)
    h = res.snapshot["histograms"]["tune/arrival_age"]
    jh = ref.snapshot["histograms"]["tune/arrival_age"]
    assert h["counts"] == jh["counts"] and h["n"] == jh["n"]
    g = res.snapshot["gauges"]
    assert g["tune/round_us"] == res.round_us
    assert res.objective == pytest.approx(
        res.round_us + runner.bytes_weight * res.bytes_per_client_round)
    if name == "straggler":
        assert res.staleness_mean > 0 and h["n"] > 0
    else:
        assert res.staleness_mean == 0.0 and h["n"] == 0
    if trial == "dense":  # the d + 1 float64 coordinates of logreg
        assert res.bytes_per_client_round == 8 * 11


def test_async_trial_draws_its_clock_on_the_cpu():
    runner = TrialRunner(Workload(clock="straggler"), device="cpu")
    draws = runner._clock_draws()
    assert draws.device == torch.device("cpu")
    assert TrialRunner(Workload(), device="cpu")._clock_draws() is None


# ---------------------------------------------------------------------------
# the trainer's --autotune
# ---------------------------------------------------------------------------

ADOPT_CLI = ["--rounds", "1", "--tau", "1", "--clients", "4", "--batch",
             "1", "--seq", "8"]


class _Stop(Exception):
    pass


@pytest.mark.parametrize("point,extra", [
    (dict(chunk_rounds=8, transport="topk", ratio=0.25,
          granularity="global", plane=True), []),
    (dict(chunk_rounds=4), []),
    (dict(chunk_rounds=8, transport="topk", ratio=0.25, plane=True,
          buffer_frac=0.5, queue_depth=2, staleness="poly",
          schedule="linear"), ["--async"]),
    (dict(transport="quantize", buffer_frac=1.0), ["--async"]),
])
def test_autotune_adopts_like_the_reference(point, extra, monkeypatch,
                                            capsys):
    from repro.launch import train as jtrain
    from repro_torch.launch import train

    rec = {"best": {"point": TrialPoint(**point).to_dict()},
           "measured_trials": 5, "cached": False}
    seen = {}

    def fake_tune(tag):
        def run(workload, *, budget, log, **kw):
            seen[tag] = (workload.clock, budget, kw)
            return rec
        return run

    def capture(tag):
        def config(**kw):
            seen[tag + "_cfg"] = kw
            raise _Stop
        return config

    monkeypatch.setattr(tune_pkg, "tune", fake_tune("port"))
    monkeypatch.setattr(jtune_pkg, "tune", fake_tune("ref"))
    monkeypatch.setattr(train, "EngineConfig", capture("port"))
    monkeypatch.setattr(jtrain, "EngineConfig", capture("ref"))
    argv = ADOPT_CLI + extra + ["--autotune", "5"]
    with pytest.raises(_Stop):
        train.build(train.parser().parse_args(argv + ["--device", "cpu"]))
    mine = capsys.readouterr().out
    with pytest.raises(_Stop):
        jtrain.main(argv)
    ref_out = capsys.readouterr().out
    line = [x for x in mine.splitlines() if x.startswith("autotune:")]
    assert line and line[0] in ref_out.splitlines()
    assert seen["port"][:2] == seen["ref"][:2]
    assert seen["port"][2] == {"device": torch.device("cpu")}
    assert _match(seen["port_cfg"], seen["ref_cfg"])
