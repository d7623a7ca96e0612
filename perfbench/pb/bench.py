"""One run of one cell: set-up, the rounds that the reference follows
(round 1 alone, then one chunk through the window's own call), the window
(or, traced, a sub-window), then the reference and the comparison that
decides ``correct``.

Set-up (``setup_s``) runs from the process's start to the end of the
checked chunk: imports, the clients' data, the weights drawn on the device,
the engine, round 1 and the checked chunk, which is the first call of the
window's shape, so every shape the window uses has run once.  The
reference runs after the window, once the peak memory has been read and
the program's state freed; its time counts nowhere.

``peak_mem_gb`` is the device's peak over the checked chunk and the
window: the check's own readings and round 1 (run alone, the initial
weights kept for the readings) are left out.
"""
from __future__ import annotations

import importlib
import importlib.util
import math
import time

import torch

from pb import check, measure, program, spec, traffic

def family(name: str):
    return importlib.import_module(f"families.{name}")


def reader(name: str):
    path = spec.metric_file(name)
    mod_spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def reference_readings(cell, fam, feed_batches, seed: int, device,
                       precision: str = "exact", loss_and_grad=None) -> dict:
    """The reference's readings of the rounds ``feed_batches`` holds, from
    the same inputs the program got: the weights drawn again from ``seed``
    and the batches of those rounds."""
    from reference import fed as ref_fed

    params0 = program.flat(fam.init_params(cell.config, seed, device))
    lg = loss_and_grad or fam.reference_loss_and_grad(cell.config, precision)
    return ref_fed.run(cell.traffic, params0, lg, feed_batches)


def device_info(device, peak: int) -> dict:
    dev = torch.device(device)
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": 1, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": int(peak)}


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> tuple:
    """(the result line's keys, ``checks`` last; for the log, the train
    losses of the checked rounds and the window's last, the set-up's parts,
    the peak memory of the checked chunk, the readings by leaf of the
    program and the reference and, untraced, the window's chunk times)."""
    cuda = torch.device(device).type == "cuda"
    parts = {"start": time.perf_counter() - t_start}

    def mark(name):
        measure.sync(device)
        parts[name] = time.perf_counter() - t_start - sum(parts.values())

    fam = family(cell.config["family"])
    data = traffic.make(cell.traffic, cell.config, seed)
    mark("data")
    prog = program.Program(cell, fam,
                           fam.init_params(cell.config, seed, device), data,
                           seed, device)
    mark("weights_engine")
    readings = prog.check_rounds(
        lambda: fam.init_params(cell.config, seed, device))
    chunk_peak = readings.pop("peak")
    mark("checked_rounds")
    setup_s = time.perf_counter() - t_start

    if trace:
        tr, losses = measure.traced_window(prog, seconds, device)
        rounds = tr.rounds
    else:
        w = measure.window(prog, seconds, device)
        losses, rounds = w["losses"], w["rounds"]
    peak = max(chunk_peak,
               torch.cuda.max_memory_allocated() if cuda else 0)
    batches = prog.feed.reference_batches(spec.checked_rounds(cell.traffic))
    prog.close()

    ref = reference_readings(cell, fam, batches, seed, device)
    correct, checks = check.judge(
        check.gaps(readings, ref, cell.traffic.get("loss_rounds")),
        cell.traffic["limits"])
    failed = sum(not math.isfinite(x) for x in losses)
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = reader(m["name"])(tr)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {"setup_s": setup_s, "round_s": w["seconds"] / rounds,
                  "peak_mem_gb": peak / 1e9}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    result = {"correct": bool(correct and failed == 0),
              "attempted": rounds, "failed": failed, "metrics": metrics,
              "device": device_info(device, peak)}
    if trace:
        result["device"].update(busy_s=tr.busy_s(), window_s=tr.window_s)
        result["breakdown"] = measure.breakdown(tr)
    result["checks"] = checks
    log = {"checked_losses": readings["loss"], "window_last_loss": losses[-1],
           "window_rounds": rounds, "setup_parts_s": parts,
           "peak_checked_chunk_gb": chunk_peak / 1e9,
           "readings": {"program": readings, "reference": ref}}
    if not trace:
        log["window_chunks_s"] = w["chunks"]
    return result, log
