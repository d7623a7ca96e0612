"""The port's multi-process runtime (repro_torch.fed.runtime), alone and
against the JAX reference's (repro.fed.runtime).  CPU only
(``device="cpu"``); the card's run is chip_smoke.py phase 14.

Port alone, the twins of tests/test_runtime.py: a server and a worker
exchanging real frames over a localhost socket give a server trajectory
BITWISE the single-process engine's -- dense, top-k (1.0 and 0.1) and
quantize transports, blocking and overlapped modes, per-leaf and plane
layouts -- overlapped equals blocking bitwise, the arrival ledger records
every chunk, two workers' FedBuff moves and stays finite, and a replica
reconstructs the server's final plane bitwise.  One true two-process
``run_pair``.

Across the packages (N = 1, server on a thread as tests/test_runtime.py
does): a torch worker against a JAX server and a JAX worker against a
torch server install the worker's committed fields bitwise with a replay
drift of at most 1e-12; both packages' workers send the same HELLO bytes;
a replica of either package fed by the other's server reconstructs
bitwise.

The engine's sinks against the reference's: the uplink sink sees the same
``(start_round, msgs)`` sequence (msgs at rtol 1e-10 / atol 1e-12, the
engine parity tests' state tolerance), and ``sink_blockers`` names the
same blockers for every stage.

Sizes: clients 8, m 16, dim 24, tau 2, 8 rounds, chunk 4, float64; every
socket wait times out after 30 s.
"""
import argparse
import json
import socket
import threading
import traceback

import jax
import numpy as np
import pytest
import torch

from repro.exec import stages as jstages
from repro.fed import runtime as jrt
from repro_torch.exec import stages
from repro_torch.fed import runtime as rt
from repro_torch.fed.runtime import _fields_bitwise


@pytest.fixture(autouse=True)
def _x64_one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with jax.enable_x64(True):
            yield
    finally:
        torch.set_num_threads(threads)


def _args(mod=rt, **kw):
    defaults = dict(clients=8, m=16, dim=24, tau=2, rounds=8, chunk=4,
                    workers=1, mode="blocking", timeout=30.0)
    if mod is rt:
        defaults["device"] = "cpu"
    defaults.update(kw)
    return mod.RuntimeArgs(**defaults)


def _run_threaded(a, worker_mod=None, replica_mod=None, server_mod=rt):
    """Server on a thread + ranks 1.. and replicas on threads, rank 0
    inline: the sockets and frames of the subprocess form, with in-test
    error propagation.  ``*_mod`` picks each side's package."""
    worker_mod = worker_mod or server_mod
    replica_mod = replica_mod or server_mod
    box, errs = {}, []
    ready = threading.Event()

    def side_args(mod):
        kw = {k: getattr(a, k) for k in jrt.RuntimeArgs.__dataclass_fields__}
        return _args(mod, **kw)

    def srv():
        try:
            box["server"] = server_mod.run_server(
                a, ready_cb=lambda p: (box.update(port=p), ready.set()))
        except BaseException:
            errs.append(traceback.format_exc())
            ready.set()

    st = threading.Thread(target=srv, daemon=True)
    st.start()
    assert ready.wait(30), "server never bound"
    assert "port" in box, f"server failed: {errs}"
    a.port = box["port"]

    def spawn(name, fn):
        def run():
            try:
                box[name] = fn()
            except BaseException:
                errs.append(traceback.format_exc())

        t = threading.Thread(target=run, daemon=True)
        t.start()
        return t

    threads = [spawn(f"worker{r}",
                     lambda r=r: worker_mod.run_worker(side_args(worker_mod),
                                                       rank=r))
               for r in range(1, a.workers)]
    threads += [spawn(f"replica{r}",
                      lambda r=r: replica_mod.run_replica(
                          side_args(replica_mod), rank=r))
                for r in range(a.replicas)]
    box["worker0"] = worker_mod.run_worker(side_args(worker_mod), rank=0)
    for t in threads:
        t.join(30)
    st.join(30)
    assert not errs, f"runtime thread failed: {errs}"
    return box


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_bits(x, y) -> bool:
    """Reference-side and port-side field trees: same keys, same bytes."""
    xl = jax.tree_util.tree_leaves(x, is_leaf=lambda v: isinstance(
        v, torch.Tensor))
    yl = jax.tree_util.tree_leaves(y, is_leaf=lambda v: isinstance(
        v, torch.Tensor))
    return (jax.tree_util.tree_structure(jax.tree_util.tree_map(_np, x))
            == jax.tree_util.tree_structure(jax.tree_util.tree_map(_np, y))
            and all(_np(p).dtype == _np(q).dtype
                    and _np(p).tobytes() == _np(q).tobytes()
                    for p, q in zip(xl, yl)))


# ---------------------------------------------------------------------------
# the port alone
# ---------------------------------------------------------------------------


def test_shard_bounds():
    assert rt.shard_bounds(8, 2) == [(0, 4), (4, 8)]
    assert rt.shard_bounds(10, 3) == [(0, 4), (4, 7), (7, 10)]
    assert rt.shard_bounds(5, 1) == [(0, 5)]


@pytest.mark.parametrize("mode", ["blocking", "overlapped"])
@pytest.mark.parametrize("transport,kw", [
    ("dense", {}), ("topk", {"ratio": 1.0}), ("topk", {"ratio": 0.1}),
    ("quantize", {"bits": 4}),
])
def test_two_process_bitwise_parity(mode, transport, kw):
    """THE pin: server state == single-process engine, bit for bit."""
    box = _run_threaded(_args(mode=mode, transport=transport, **kw))
    local = rt.run_local(_args(mode=mode, transport=transport, **kw))
    assert _fields_bitwise(local["fields"], box["server"]["fields"])
    assert _fields_bitwise(local["fields"], box["worker0"]["fields"])
    assert box["server"]["max_replay_drift"] == 0.0


@pytest.mark.parametrize("transport", ["dense", "topk", "quantize"])
def test_plane_layout_parity(transport):
    """Plane mode: the uplink crosses as ONE flat buffer per chunk."""
    a = _args(plane=True, mode="overlapped", transport=transport)
    box = _run_threaded(a)
    local = rt.run_local(_args(plane=True, transport=transport))
    assert _fields_bitwise(local["fields"], box["server"]["fields"])
    assert box["server"]["max_replay_drift"] <= 1e-12


def test_compressed_transports_save_bytes():
    dense = _run_threaded(_args())
    topk = _run_threaded(_args(transport="topk", ratio=0.1))
    quant = _run_threaded(_args(transport="quantize", bits=4))
    nb = dense["worker0"]["bytes_sent"]
    assert topk["worker0"]["bytes_sent"] < 0.7 * nb
    assert quant["worker0"]["bytes_sent"] < 0.7 * nb
    assert topk["worker0"]["encoding"] == "sparse"
    assert quant["worker0"]["encoding"] == "palette"


def test_overlapped_matches_blocking_bitwise():
    b = _run_threaded(_args(mode="blocking", batch_size=4))
    o = _run_threaded(_args(mode="overlapped", batch_size=4))
    assert _fields_bitwise(b["server"]["fields"], o["server"]["fields"])
    assert b["worker0"]["bytes_sent"] == o["worker0"]["bytes_sent"]


def test_arrival_ledger_records_real_arrivals():
    box = _run_threaded(_args(rounds=8, chunk=2))  # 4 chunks -> 4 arrivals
    led = box["server"]["ledger"]
    assert led["arrivals"] == 4 and led["workers"] == 1
    assert led["bytes"] == box["worker0"]["bytes_sent"]
    assert box["server"]["version"] == 4
    assert led["max_age"] == 0  # blocking: each chunk ACKed before the next
    assert np.asarray(box["server"]["age_histogram"]).sum() == 4
    m = box["server"]["metrics"]
    assert m["counters"]["commits"] == 4.0
    assert m["gauges"]["commit/weight"] == 1.0


def test_two_workers_fedbuff_converges():
    box = _run_threaded(_args(workers=2, mode="overlapped"))
    res = box["server"]
    assert res["ledger"]["workers"] == 2
    assert res["version"] == 4  # 2 workers x 2 chunks
    w = np.asarray(res["fields"]["x_bar"]["w"])
    assert np.all(np.isfinite(w)) and np.abs(w).max() > 0
    assert {box["worker0"]["lo"], box["worker1"]["lo"]} == {0, 4}


def test_worker_report_accounting():
    a = _args(mode="blocking")
    rep = _run_threaded(a)["worker0"]
    assert rep["chunks"] == 2 and rep["bytes_sent"] > 0
    assert rep["send_wait_s"] >= 0.0 and rep["sender_busy_s"] > 0.0
    assert rep["rounds"] == a.rounds
    assert len(rep["metrics"]["train_loss"]) == a.rounds


def test_replica_reconstructs_bitwise_and_metrics_jsonl(tmp_path):
    a = _args(replicas=1, keyframe_every=2, mode="overlapped",
              metrics_jsonl=str(tmp_path / "m.jsonl"))
    box = _run_threaded(a)
    rep = box["replica0"]
    assert rep["ok"] and rep["version"] == box["server"]["version"] == 2
    assert rep["keyframes"] >= 1
    assert _fields_bitwise(rep["server_result"]["fields"],
                           box["server"]["fields"])
    lines = (tmp_path / "m.jsonl").read_text().splitlines()
    assert len(lines) == 3  # one per commit + the final snapshot


def test_traced_pair_writes_one_valid_trace(tmp_path):
    from repro_torch.obs import report, trace

    a = _args(mode="overlapped", trace=str(tmp_path / "t.json"))
    box = _run_threaded(a)
    doc = json.loads((tmp_path / "t.json").read_text())
    assert trace.validate_chrome(doc) == []
    names = {e["name"] for e in doc["traceEvents"] if e.get("ph") == "X"}
    assert {"exec/chunk", "uplink/ship", "uplink/wait", "server/commit",
            "wire/send"} <= names
    rep = report.overlap_report(doc)
    assert rep["totals"]["chunks"] == 2
    assert 0.0 <= report.hidden_fraction(doc) <= 1.0
    assert _fields_bitwise(box["server"]["fields"],
                           rt.run_local(_args())["fields"])


def test_true_subprocess_pair_parity():
    """One server OS process (``--device cpu``) + rank 0 here."""
    a = _args(mode="overlapped")
    rep = rt.run_pair(a)
    local = rt.run_local(_args(mode="overlapped"))
    assert _fields_bitwise(local["fields"], rep["server_result"]["fields"])
    assert rep["server_result"]["max_replay_drift"] == 0.0


def test_cli_roundtrip_of_the_args():
    a = _args(plane=True, transport="topk", ratio=0.25, replicas=2,
              throttle_bw=1e9, trace="t.json", batch_size=3, x64=False)
    ap = argparse.ArgumentParser()
    rt.add_runtime_args(ap)
    assert rt._from_ns(ap.parse_args(rt._to_argv(a))) == a


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sides", ["jax-server", "torch-server"])
@pytest.mark.parametrize("kw", [
    {}, {"mode": "overlapped", "plane": True},
    {"transport": "topk", "ratio": 0.1}, {"transport": "quantize", "bits": 4},
], ids=["dense", "plane", "topk", "quantize"])
def test_cross_package_pair_installs_the_workers_fields(sides, kw):
    server_mod, worker_mod = (jrt, rt) if sides == "jax-server" else (rt,
                                                                      jrt)
    box = _run_threaded(_args(server_mod, **kw), server_mod=server_mod,
                        worker_mod=worker_mod)
    assert _same_bits(box["server"]["fields"], box["worker0"]["fields"])
    assert box["server"]["max_replay_drift"] <= 1e-12
    assert box["server"]["version"] == 2


def _captured_hello(mod, **kw) -> bytes:
    """The raw HELLO frame a worker of ``mod`` sends (a listener that
    reads one frame and hangs up)."""
    a = _args(mod, **kw)
    ls = socket.socket()
    ls.bind(("127.0.0.1", 0))
    ls.listen(1)
    ls.settimeout(30)
    a.port = ls.getsockname()[1]
    got = {}

    def listen():
        conn, _ = ls.accept()
        conn.settimeout(30)
        got["buf"] = rt._recv_raw_frame(conn)
        conn.close()
        ls.close()

    t = threading.Thread(target=listen, daemon=True)
    t.start()
    with pytest.raises(Exception):  # the listener hangs up after HELLO
        mod.run_worker(a, rank=0)
    t.join(30)
    return got["buf"]


@pytest.mark.parametrize("kw", [
    {}, {"plane": True}, {"transport": "quantize", "encoding": "palette"},
    {"workers": 2, "mode": "overlapped"},
], ids=["dense", "plane", "quantize", "two-workers"])
def test_hello_bytes_are_the_references(kw):
    assert _captured_hello(rt, **kw) == _captured_hello(jrt, **kw)


@pytest.mark.parametrize("replica", ["torch", "jax"])
def test_replica_of_either_package_reconstructs_bitwise(replica):
    """A torch replica fed by a JAX server, and the other way round."""
    server_mod, replica_mod = (jrt, rt) if replica == "torch" else (rt, jrt)
    a = _args(server_mod, replicas=1, keyframe_every=2, mode="overlapped")
    box = _run_threaded(a, server_mod=server_mod, replica_mod=replica_mod)
    assert box["replica0"]["ok"] and box["replica0"]["applied"] >= 1
    assert _same_bits(box["replica0"]["server_result"]["fields"],
                      box["server"]["fields"])


# ---------------------------------------------------------------------------
# the engine's sinks against the reference's
# ---------------------------------------------------------------------------


def _recording():
    seen = []

    def sink(start_round, msgs, state):
        seen.append((int(start_round), jax.tree_util.tree_map(
            lambda x: _np(x).copy(), msgs)))

    return seen, sink


@pytest.mark.parametrize("kw", [
    {}, {"transport": "topk", "ratio": 1.0}, {"plane": True},
    {"plane": True, "transport": "topk", "ratio": 1.0},
], ids=["dense", "topk1", "plane", "plane-topk1"])
def test_uplink_sink_sees_the_references_messages(kw):
    jseen, jsink = _recording()
    tseen, tsink = _recording()
    jrt.run_local(_args(jrt, rounds=8, chunk=3, **kw), sink=jsink)
    rt.run_local(_args(rounds=8, chunk=3, **kw), sink=tsink)
    assert [r for r, _ in tseen] == [r for r, _ in jseen] == [0, 3, 6]
    for (_, t), (_, j) in zip(tseen, jseen):
        tl, jl = jax.tree_util.tree_leaves(t), jax.tree_util.tree_leaves(j)
        assert [x.shape for x in tl] == [x.shape for x in jl]
        for x, y in zip(tl, jl):
            np.testing.assert_allclose(x, y, rtol=1e-10, atol=1e-12)


def _stacks():
    """The same stage combinations in both packages: (name, port stack,
    reference stack, participation)."""
    from repro import comm as jcomm
    from repro.exec import EngineConfig as JConfig
    from repro_torch import comm as tcomm
    from repro_torch.exec import EngineConfig as TConfig

    combos = {
        "none": {}, "uplink": {"transport": "topk"},
        "downlink": {"downlink": "topk"}, "async": {"buffer_size": 2},
        "cohort": {"population": 8, "cohort": 4},
        "participation": {"participation": 0.5},
        "protocol": {"protocol": True},
        "async+cohort": {"buffer_size": 2, "population": 8, "cohort": 4},
    }
    out = []
    for name, kw in combos.items():
        tkw, jkw = dict(kw), dict(kw)
        for side, mod in ((tkw, tcomm), (jkw, jcomm)):
            for key in ("transport", "downlink"):
                if key in side:
                    side[key] = mod.TopK(0.5)
        out.append((name, TConfig(**tkw).resolve(), JConfig(**jkw).resolve(),
                    "participation" in kw))
    return out


@pytest.mark.parametrize("kind", ["uplink", "snapshot"])
@pytest.mark.parametrize("jit", [True, False])
def test_sink_blockers_are_the_references(kind, jit):
    for name, tstack, jstack, part in _stacks():
        got = stages.sink_blockers(tstack, participation=part, jit=jit,
                                   kind=kind)
        exp = jstages.sink_blockers(jstack, participation=part, jit=jit,
                                    kind=kind)
        assert got == exp, name
    with pytest.raises(ValueError, match="unknown sink kind"):
        stages.sink_blockers(tstack, participation=False, jit=True,
                             kind="bogus")


def test_engine_refuses_sinks_where_the_reference_does():
    from repro_torch.comm import Dense
    from repro_torch.core.algorithm import DProxConfig
    from repro_torch.core.prox import L1
    from repro_torch.exec import EngineConfig, RoundEngine
    from repro_torch.fed.simulator import DProxAlgorithm
    from repro_torch.models import logreg

    alg = DProxAlgorithm(L1(0.01), DProxConfig(2, 0.05, 2.0))

    def eng(**kw):
        return RoundEngine(alg, logreg.make_grad_fn(), 8,
                           EngineConfig(**kw), device="cpu")

    def noop(*a):
        return None

    with pytest.raises(ValueError, match="split"):
        eng().set_uplink_sink(noop)
    with pytest.raises(ValueError, match="asynchrony"):
        eng(buffer_size=4).set_uplink_sink(noop)
    with pytest.raises(ValueError, match="cohort"):
        eng(transport=Dense(), population=8, cohort=4).set_uplink_sink(noop)
    with pytest.raises(ValueError, match="participation"):
        eng(transport=Dense(), participation=0.5).set_uplink_sink(noop)
    with pytest.raises(ValueError, match="protocol"):
        eng(protocol=True).set_snapshot_sink(noop)
    # the snapshot sink composes with the other stages
    eng(transport=Dense(), population=8, cohort=4).set_snapshot_sink(noop)
    eng(buffer_size=4).set_snapshot_sink(noop)
    e = eng(transport=Dense())
    e.set_uplink_sink(noop)
    e.set_uplink_sink(None)


def test_snapshot_sink_publishes_every_chunk_into_a_store():
    """The snapshot sink composes with the plain engine: one publish per
    chunk, before the host sync, the committed server fields bitwise."""
    from repro_torch.exec import server_state_fields
    from repro_torch.serving import SnapshotStore

    a = _args()
    eng, alg, grad_fn, data, params0 = rt._engine(a, a.clients)
    store = SnapshotStore()
    eng.set_snapshot_sink(store.engine_sink(
        lambda s: server_state_fields(alg, s)))
    state, _ = eng.run(eng.init(params0), rt._supplier(a, data, 0, 8), 8)
    assert store.version == 2 and store.latest().round == 8
    assert torch.equal(store.latest().value["x_bar"]["w"],
                       state.x_bar["w"])
