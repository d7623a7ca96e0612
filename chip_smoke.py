#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``).

    python3 chip_smoke.py          # needs one CUDA card; exits non-zero without

Phases, each asserting (any failure exits non-zero and prints no result):

  0. device    -- a CUDA card is present; print its name and power limit
                  (nvidia-smi) and the torch / CUDA versions;
  1. build     -- build the kernel library from src/repro_torch/kernels/csrc;
  2. kernels   -- the fused local-update + L1-prox kernel against its plain
                  PyTorch version on the card, compared as integer bit
                  patterns (-0.0 and NaN included), in float32, bfloat16 and
                  float64 at (30, 4,194,304), and float64 at the main path's
                  shapes (30, 21) and (30, 112,395) and at (1, 21); median
                  kernel and plain times (CUDA events) beside the bound;
  3. main path -- the paper's Fig. 2 problem (n 30, m 100, d 20, float64)
                  through repro_torch.fed.simulator.run on the card, DProx
                  tau = 10 and tau = 1, 500 rounds: the kernel runs exactly
                  rounds * tau times, and the optimality sequence matches the
                  same run on the CPU (plain step) at rtol 1e-6 above 1e-9;
  4. wide      -- the same model and generator at d = 112,394 (the federated
                  state width of the paper's Fig. 4 CNN), features cached on
                  the card, tau = 10 for 20 rounds: launches == rounds * tau,
                  optimality finite and decreasing; s/round and the kernel's
                  share of the round's device time; and, for the record of
                  its two departures from the reference's set-up, the
                  gradient at zero against the paper's lam and the
                  trajectory with the reference's L.

The line before the last is the kernels' JSON summary; the last line is
``{"ok": true, "device": {...}}``.  A copy of the summary goes to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ETA, THRESH = 0.37, 0.21
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
# peak rate of the kernel's arithmetic (vector units, no tensor cores) per
# compute type, H100 SXM data sheet: FP32 67 TFLOP/s, FP64 34 TFLOP/s
PEAK_OPS = {"float32": 67e12, "bfloat16": 67e12, "float64": 34e12}
OPS_PER_ELEMENT = 10  # add, mul, sub, abs, sub, max, 2 compares, sub, mul


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# -- phase 0 ------------------------------------------------------------------

def phase_device():
    import torch

    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    check(torch.cuda.device_count() >= 1, "no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"[device] {card}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} "
        f"devices {torch.cuda.device_count()}")
    return card


# -- phase 1 ------------------------------------------------------------------

def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    lib = _build.build()
    _build.load_library()
    log(f"[build] {lib.name} in {time.perf_counter() - t0:.2f} s")


# -- phase 2 ------------------------------------------------------------------

def _time_ms(fn, reps: int, batch: int) -> float:
    """Device time of one ``fn()``: CUDA events around ``batch`` back-to-back
    calls, divided by ``batch``; the median over ``reps`` such batches."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / batch)
    return statistics.median(times)


def _kernel_case(shape, dtype, card: str, seed: int):
    import torch

    from repro_torch.kernels import fused_prox as fp

    gen = torch.Generator(device="cuda").manual_seed(seed)
    mk_dtype = torch.float64 if dtype == torch.float64 else torch.float32
    zh, g, c = (torch.randn(shape, generator=gen, device="cuda",
                            dtype=mk_dtype).to(dtype) for _ in range(3))
    # special values: NaN, -0.0, +-inf, and exactly the threshold
    specials = [float("nan"), -0.0, float("inf"), -float("inf"), THRESH,
                -THRESH, 0.0]
    k = min(len(specials), zh.shape[-1])
    zh[0, :k] = torch.tensor(specials[:k], dtype=dtype)
    g[0, :k] = 0
    c[0, :k] = 0

    k_zh, k_z = fp.fused_local_update_2d(zh, g, c, ETA, THRESH)
    p_zh, p_z = fp.fused_local_update_plain(zh, g, c, ETA, THRESH)
    torch.cuda.synchronize()
    ity = {2: torch.int16, 4: torch.int32, 8: torch.int64}[zh.element_size()]
    same_zh = int((k_zh.view(ity) != p_zh.view(ity)).sum())
    same_z = int((k_z.view(ity) != p_z.view(ity)).sum())
    fin = torch.isfinite(p_zh) & torch.isfinite(p_z)
    err = max(float((k_zh - p_zh)[fin].abs().max()),
              float((k_z - p_z)[fin].abs().max()))
    check(same_zh == 0 and same_z == 0,
          f"kernel != plain bitwise at {shape} {dtype}: "
          f"{same_zh} z_hat' and {same_z} z' elements differ")

    n = zh.numel()
    batch = 1 if n > 1e8 else 10
    ms = _time_ms(lambda: fp.fused_local_update_2d(zh, g, c, ETA, THRESH),
                  15, batch)
    plain_ms = _time_ms(
        lambda: fp.fused_local_update_plain(zh, g, c, ETA, THRESH), 15, batch)
    nbytes = 5 * n * zh.element_size()
    work = str(dtype).replace("torch.", "")
    bound_ms = 1e3 * max(nbytes / HBM_BYTES_PER_S,
                         OPS_PER_ELEMENT * n / PEAK_OPS[work])
    bound_by = ("bytes" if nbytes / HBM_BYTES_PER_S
                >= OPS_PER_ELEMENT * n / PEAK_OPS[work] else "operations")
    row = {"shape": list(shape), "dtype": work, "bitwise_equal": True,
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "GB_per_s": nbytes / (ms * 1e-3) / 1e9}
    log(f"[kernels] {tuple(shape)} {work}: bitwise equal; kernel "
        f"{ms:.4f} ms ({row['GB_per_s']:.0f} GB/s), bound {bound_ms:.4f} ms "
        f"({bound_by}), plain {plain_ms:.4f} ms  [{card}]")
    del zh, g, c, k_zh, k_z, p_zh, p_z
    torch.cuda.empty_cache()
    return row


def phase_kernels(card: str):
    import torch

    cases = [((30, 4_194_304), torch.float32), ((30, 4_194_304), torch.bfloat16),
             ((30, 4_194_304), torch.float64), ((30, 112_395), torch.float64),
             ((30, 21), torch.float64), ((1, 21), torch.float64)]
    return [_kernel_case(shape, dt, card, seed)
            for seed, (shape, dt) in enumerate(cases)]


# -- phase 3 ------------------------------------------------------------------

def _fig2_run(tau: int, device: str, rounds: int, eval_every: int):
    from repro_torch.core.algorithm import DProxConfig
    from repro_torch.data.synthetic import make_round_batches
    from repro_torch.fed import problems, simulator

    data, reg, grad_fn, full_g, params0, L = problems.logreg_problem(
        device=device)
    eta_g = 15.0
    eta_tilde = 0.5 / L
    eta = eta_tilde / (eta_g * tau)
    alg = simulator.DProxAlgorithm(reg, DProxConfig(tau=tau, eta=eta,
                                                    eta_g=eta_g))
    return simulator.run(
        alg, params0, grad_fn,
        lambda r, rng: make_round_batches(data, tau, None, rng), 30, rounds,
        reg=reg, eta_tilde=eta_tilde, full_grad_fn=full_g,
        eval_every=eval_every, device=device)


def phase_main_path(card: str):
    import torch

    from repro_torch.kernels import fused_prox as fp

    rounds, every = 500, 25
    out = {}
    for tau in (10, 1):
        fp.fused_local_update_2d.launches = 0
        t0 = time.perf_counter()
        h = _fig2_run(tau, "cuda", rounds, every)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = fp.fused_local_update_2d.launches
        check(launches == rounds * tau,
              f"tau={tau}: {launches} kernel launches, expected {rounds * tau}")
        threads = torch.get_num_threads()
        torch.set_num_threads(1)  # the small CPU reference runs faster so
        try:
            h_cpu = _fig2_run(tau, "cpu", rounds, every)
        finally:
            torch.set_num_threads(threads)
        check(fp.fused_local_update_2d.launches == launches,
              "the CPU run launched the kernel")
        opt, ref = h.optimality, h_cpu.optimality
        check(len(opt) == len(ref) == rounds // every + 1,
              f"tau={tau}: {len(opt)} eval points")
        check(all(math.isfinite(v) for v in opt), f"tau={tau}: non-finite")
        for i, (a, b) in enumerate(zip(opt, ref)):
            if b > 1e-9:
                check(abs(a - b) <= 1e-6 * abs(b),
                      f"tau={tau} eval {i}: cuda {a!r} vs cpu {b!r}")
            else:
                check(a <= 1e-9, f"tau={tau} eval {i}: cuda {a!r} > 1e-9")
        max_rel = max(abs(a - b) / b for a, b in zip(opt, ref) if b > 1e-9)
        log(f"[main] fig2 tau={tau}: {rounds} rounds in {secs:.2f} s, "
            f"{launches} launches, final optimality {opt[-1]:.6e} "
            f"(cpu {ref[-1]:.6e}, max rel diff {max_rel:.2e})  [{card}]")
        out[f"tau{tau}"] = {"rounds": rounds, "launches": launches,
                            "seconds": secs, "final_optimality": opt[-1],
                            "final_optimality_cpu": ref[-1],
                            "max_rel_diff": max_rel}
    return out


# -- phase 4 ------------------------------------------------------------------

def phase_wide(card: str, kernel_ms: float):
    import torch

    from repro_torch.core.algorithm import DProxConfig
    from repro_torch.exec import ArraySupplier, EngineConfig, RoundEngine
    from repro_torch.fed import problems, simulator
    from repro_torch.kernels import fused_prox as fp

    d, tau, rounds, every = 112_394, 10, 20, 5
    # features normalized to unit max row norm shrink each coordinate, and
    # so each |df/dw_j|, by about sqrt(20/d) against the paper's d = 20; at
    # lam = 0.003 every |df/dw_j(0)| is below lam, so the first prox steps
    # leave every weight at zero and only the bias moves; lam shrinks with
    # them
    lam = 0.003 * math.sqrt(20 / d)
    t0 = time.perf_counter()
    data, reg, grad_fn, full_g, params0, L_ref = problems.logreg_problem(
        d=d, lam=lam, device="cuda")
    # the step needs L with the bias column at this width (see smoothness)
    L = problems.smoothness(data.features, "cuda", bias=True)
    supplier = ArraySupplier.from_dataset(data, tau, None, device_cache=True,
                                          device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    feat_gb = data.features.nbytes / 1e9
    log(f"[wide] d={d}: lam={lam:.6e}, set-up {setup_s:.1f} s, L={L:.6e}, features "
        f"{feat_gb:.2f} GB on the card")
    eta_g = 15.0
    eta_tilde = 0.5 / L
    eta = eta_tilde / (eta_g * tau)
    alg = simulator.DProxAlgorithm(reg, DProxConfig(tau=tau, eta=eta,
                                                    eta_g=eta_g))

    fp.fused_local_update_2d.launches = 0
    h = simulator.run(alg, params0, grad_fn, supplier, 30, rounds, reg=reg,
                      eta_tilde=eta_tilde, full_grad_fn=full_g,
                      eval_every=every, device="cuda")
    torch.cuda.synchronize()
    launches = fp.fused_local_update_2d.launches
    check(launches == rounds * tau,
          f"wide: {launches} launches, expected {rounds * tau}")
    opt = h.optimality
    check(all(math.isfinite(v) for v in opt), f"wide: non-finite {opt}")
    check(all(b < a for a, b in zip(opt, opt[1:])),
          f"wide: optimality not decreasing {opt}")
    log(f"[wide] tau={tau}: {rounds} rounds, {launches} launches, "
        f"optimality {['%.6e' % v for v in opt]}")

    # the two departures from the reference's set-up, measured: the gradient
    # at zero against the paper's lam, and the run with the reference's L
    # (no bias column)
    grad0 = full_g(params0)
    grad0_w = float(grad0["w"].abs().max())
    grad0_b = float(grad0["b"].abs())
    ref_eta_tilde = 0.5 / L_ref
    ref_alg = simulator.DProxAlgorithm(reg, DProxConfig(
        tau=tau, eta=ref_eta_tilde / (eta_g * tau), eta_g=eta_g))
    opt_ref_L = simulator.run(
        ref_alg, params0, grad_fn, supplier, 30, rounds, reg=reg,
        eta_tilde=ref_eta_tilde, full_grad_fn=full_g, eval_every=every,
        device="cuda").optimality
    log(f"[wide] at zero: max |df/dw_j| {grad0_w:.6e}, |df/db| {grad0_b:.6e} "
        f"(paper's lam 0.003); with the reference's L={L_ref:.6e}: "
        f"optimality {['%.6e' % v for v in opt_ref_L]}")

    # timing, outside the counted run: s/round after a first warm chunk
    eng = RoundEngine(alg, grad_fn, 30, EngineConfig(chunk_rounds=4),
                      device="cuda")
    state = eng.init(params0)
    state, _ = eng.run(state, supplier, 4)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = eng.run(state, supplier, 8)
    torch.cuda.synchronize()
    s_per_round = (time.perf_counter() - t0) / 8

    # where one round's device time goes
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        state, _ = eng.run(state, supplier, 1)
        end.record()
        torch.cuda.synchronize()
    round_ms = start.elapsed_time(end)
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3)
    busy_ms = sum(by_name.values())
    ours_ms = sum(v for k, v in by_name.items() if "fused_prox_kernel" in k)
    if busy_ms > 0:
        share = ours_ms / busy_ms
        source = "torch.profiler"
    else:  # the profiler saw no device time: estimate from phase 2
        share = tau * kernel_ms / round_ms
        source = "CUDA events (phase-2 kernel time x tau / round time)"
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    log(f"[wide] {s_per_round:.4f} s/round after the first chunk; one round "
        f"{round_ms:.3f} ms on the card, device busy {busy_ms:.3f} ms "
        f"(idle share {1 - busy_ms / round_ms:.3f}); kernel share "
        f"{share:.4f} ({source})  [{card}]")
    for name, ms in top:
        log(f"[wide]   {ms:9.3f} ms  {name[:110]}")
    return {"d": d, "tau": tau, "rounds": rounds, "launches": launches,
            "optimality": opt, "setup_s": setup_s, "features_gb": feat_gb,
            "L": L, "L_reference": L_ref, "grad0_w_abs_max": grad0_w,
            "grad0_b_abs": grad0_b,
            "optimality_with_reference_L": opt_ref_L,
            "s_per_round": s_per_round, "round_ms": round_ms,
            "device_busy_ms": busy_ms, "kernel_ms_per_round": ours_ms,
            "kernel_share": share, "share_source": source,
            "top_kernels_ms": top}


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a "
             "CUDA card")
    src = ROOT / "src"
    if not (src / "repro_torch" / "__init__.py").is_file():
        fail(f"no src/repro_torch next to {Path(__file__).name}: run it "
             "from a checkout of the repository")
    sys.path.insert(0, str(src))
    t_start = time.perf_counter()
    card = phase_device()
    phase_build()
    rows = phase_kernels(card)
    main = phase_main_path(card)
    wide_row = next(r for r in rows if r["shape"] == [30, 112_395])
    wide = phase_wide(card, wide_row["ms"])

    summary = {
        "card": card,
        "kernels": [{
            "name": "fused_local_update",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/fused_prox.cu",
            "replaces": "src/repro/kernels/fused_prox.py:29",
            "launches": (main["tau10"]["launches"] + main["tau1"]["launches"]
                         + wide["launches"]),
            "max_abs_err": wide_row["max_abs_err"],
            "ms": wide_row["ms"],
            "plain_ms": wide_row["plain_ms"],
            "bound_ms": wide_row["bound_ms"],
            "bound_by": wide_row["bound_by"],
            "library_ms": None,
        }],
        "kernel_cases": rows,
        "main_path": main,
        "wide": wide,
        "seconds": time.perf_counter() - t_start,
    }
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(summary, indent=1))
    log(f"[done] {summary['seconds']:.1f} s  [{card}]")
    log(card)
    log(json.dumps({"kernels": summary["kernels"]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
