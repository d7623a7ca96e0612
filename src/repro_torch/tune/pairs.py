"""Roofline hillclimbing on the selected (arch x shape) pairs.

The counterpart of :mod:`repro.tune.pairs`: the model-scale cousin of
:func:`repro_torch.tune.search.tune` -- hypothesis -> change -> re-trace
-> re-analyse -> confirmed/refuted -- where the measurement is a
probe-based roofline analysis of the traced step
(:mod:`repro_torch.launch.dryrun`) instead of a wall-clock trial.  The
pairs and their hypotheses are the reference's:

  * stablelm-1.6b x train_4k   -- the plan-A federated round (16 clients);
    H1 batch-parallel inner step (``inner_dp``), H2 blocked attention,
    H3 both;
  * gemma2-9b x prefill_32k    -- the serving side's memory picture;
    blocked attention (and a smaller query block), then a replicated
    embedding table and last-position logits on top;
  * deepseek-v3-671b x train_4k -- the largest absolute roofline fraction;
    32 micro-batches, then blocked attention on top.

The port's traces count what the eager program does, so a hypothesis the
reference confirmed on XLA's costs may read differently here (the dry run's
module docstring says how each step is placed).  Variant reports land in
``<outdir>/*_<variant>.json`` (default ``experiments/perf_torch/dryrun``;
the pair's baseline is traced there first when absent) and the comparison
table in ``experiments/perf_torch/<pair>.md`` of the working directory.

    PYTHONPATH=src python -m repro_torch.tune.pairs --pair stablelm
"""
from __future__ import annotations

import argparse
import json
import pathlib
from functools import partial

from repro_torch.configs import registry
from repro_torch.launch import dryrun as dr

DEFAULT_OUTDIR = "experiments/perf_torch/dryrun"
TABLE_DIR = "experiments/perf_torch"


def _variants_stablelm():
    cfg = registry.get("stablelm_1_6b")
    return "stablelm_1_6b", "train_4k", [
        # H1: per-layer tensor-parallel activation all-reduces dominate the
        # collective term, not the one-vector-per-round uplink: resharding
        # the per-client batch over 'model' makes the inner step
        # batch-parallel
        ("inner_dp", cfg, {"train": partial(dr.build_train, inner_dp=True)}),
        # H2: the S^2 attention logits dominate the bytes; blocked
        # attention keeps (block_q, S) tiles
        ("blocked", cfg.with_overrides(attn_impl="blocked"), None),
        # H3: compose both
        ("inner_dp_blocked", cfg.with_overrides(attn_impl="blocked"),
         {"train": partial(dr.build_train, inner_dp=True)}),
    ]


def _variants_gemma2():
    cfg = registry.get("gemma2_9b")
    return "gemma2_9b", "prefill_32k", [
        # H1: global-layer S^2 logits dominate prefill memory: blocked
        # attention
        ("blocked", cfg.with_overrides(attn_impl="blocked"), None),
        # H2: a smaller query block shrinks the live tiles further
        ("blocked_bq256", cfg.with_overrides(attn_impl="blocked",
                                             attn_block_q=256), None),
        # H5: a replicated embedding table keeps the gather local
        ("blocked_replembed", cfg.with_overrides(attn_impl="blocked"),
         {"prefill": partial(dr.build_prefill, replicate_embed=True)}),
        # H6: + last-position logits (slice the hidden states first)
        ("blocked_replembed_lastonly", cfg.with_overrides(attn_impl="blocked"),
         {"prefill": partial(dr.build_prefill, replicate_embed=True,
                             last_only=True)}),
    ]


def _variants_deepseek():
    cfg = registry.get("deepseek_v3_671b")
    return "deepseek_v3_671b", "train_4k", [
        # H1: the live activations dominate temp: micro=32 quarters them
        ("micro32", cfg, {"train": partial(dr.build_train, micro=32)}),
        # H2: + blocked attention for MLA's train path
        ("micro32_blocked", cfg.with_overrides(attn_impl="blocked"),
         {"train": partial(dr.build_train, micro=32)}),
    ]


PAIRS = {
    "stablelm": _variants_stablelm,
    "gemma2": _variants_gemma2,
    "deepseek": _variants_deepseek,
}


def _ensure_baseline(arch, shape, outdir, cfg=None) -> dict:
    """Load the pair's single-pod baseline report, tracing it first when
    absent."""
    base_path = pathlib.Path(outdir) / f"{arch}_{shape}_single.json"
    if not base_path.exists():
        status, rep = dr.run_one(arch, shape, "single", outdir=outdir,
                                 cfg_override=cfg)
        assert status == "ok", (status, rep)
        print("BASELINE", rep.summary(), flush=True)
    return json.loads(base_path.read_text())


def run_pair(key: str, outdir: str = DEFAULT_OUTDIR, *, baseline_cfg=None):
    """Trace the pair's baseline (if absent) and every variant; write the
    comparison table.  ``baseline_cfg`` overrides the baseline's config
    (a smoke stand-in)."""
    arch, shape, variants = PAIRS[key]()
    rows = [("baseline", _ensure_baseline(arch, shape, outdir,
                                          baseline_cfg))]
    for note, cfg, builders in variants:
        b = dict(dr.BUILDERS)
        if builders:
            b.update(builders)
        status, rep = dr.run_one(arch, shape, "single", outdir=outdir,
                                 builders=b, note=note, cfg_override=cfg)
        assert status == "ok", (status, rep)
        print("DONE", rep.summary(), flush=True)
        rows.append((note, json.loads(
            (pathlib.Path(outdir) / f"{arch}_{shape}_single_{note}.json")
            .read_text())))
    perf = pathlib.Path(TABLE_DIR)
    perf.mkdir(parents=True, exist_ok=True)
    lines = [
        f"# {arch} x {shape} (single pod)",
        "",
        "| variant | compute (s) | memory (s) | collective (s) | dominant "
        "| temp GB/dev | useful |",
        "|---|---|---|---|---|---|---|",
    ]
    for name, r in rows:
        lines.append(
            f"| {name} | {r['compute_s']:.4g} | {r['memory_s']:.4g} "
            f"| {r['collective_s']:.4g} | {r['dominant']} "
            f"| {r['memory_per_dev_gb'].get('temp', float('nan')):.2f} "
            f"| {r['useful_ratio']:.1%} |")
    (perf / f"{key}.md").write_text("\n".join(lines) + "\n")
    print("\n".join(lines))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--pair", default="all", choices=["all", *PAIRS])
    ap.add_argument("--outdir", default=DEFAULT_OUTDIR)
    args = ap.parse_args(argv)
    keys = list(PAIRS) if args.pair == "all" else [args.pair]
    for k in keys:
        run_pair(k, outdir=args.outdir)
    from repro_torch.launch import mesh as mesh_lib

    mesh_lib.close_world()


if __name__ == "__main__":
    main()
