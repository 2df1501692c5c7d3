"""Hillclimb tool of the port: one cell under a named variant, through the
LM dry run (``launch/dryrun.py``) or, for ``--target edm``, the EDM dry
run on the card (``launch/edm_dryrun.py``); prints the roofline terms.

  PYTHONPATH=src python -m repro_torch.bench.hillclimb --target minicpm-prefill \\
      --variant chunked+last+seq_shard
  PYTHONPATH=src python -m repro_torch.bench.hillclimb --target minicpm-train \\
      --variant "chunked_attn&bf16_moments"     # a train-config variant after '&'
  PYTHONPATH=src python -m repro_torch.bench.hillclimb --target edm --variant lib4

The counterpart of the JAX package's ``benchmarks/hillclimb.py``: the same
LM variants and targets (every one runs: ``attn_seq_shard`` is ported).
The EDM target's variants are those that mean something in the port
(``lib_block``, ``target_block``, ``dist_dtype``); JAX's ``knn_impl``
variants (``unroll``, ``rebuild``, ``blocked:g``) are XLA fusion schedules
of one recurrence, which eager PyTorch runs as the same loop and the card
through the same kernel, so they are refused by name.  ``--smoke`` runs
an LM target's smoke config (a quick check on a host without a card).
The JSON goes to ``build/hillclimb/<target>__<variant>.json`` (or
``--out``), never under ``benchmarks/``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib

REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]
RESULTS = REPO_ROOT / "build" / "hillclimb"

#: variant name -> (config overrides, policy overrides): JAX's list
LM_VARIANTS = {
    "baseline": ({}, {}),
    "chunked_attn": ({"attn_impl": "chunked", "attn_chunk": 1024}, {}),
    "chunked_attn_512": ({"attn_impl": "chunked", "attn_chunk": 512}, {}),
    "chunked_attn_2048": ({"attn_impl": "chunked", "attn_chunk": 2048}, {}),
    "last_logits": ({"prefill_last_only": True}, {}),
    "chunked+last_logits": (
        {"attn_impl": "chunked", "attn_chunk": 1024, "prefill_last_only": True}, {}),
    "dp_only": ({}, {"dp_only": True, "fsdp": False}),
    "chunked+dp_only": (
        {"attn_impl": "chunked", "attn_chunk": 1024},
        {"dp_only": True, "fsdp": False}),
    "chunked+dp_only+last": (
        {"attn_impl": "chunked", "attn_chunk": 1024, "prefill_last_only": True},
        {"dp_only": True, "fsdp": False}),
    "fsdp_off": ({}, {"fsdp": False}),
    "dp_only+fsdp": ({}, {"dp_only": True, "fsdp": True}),
    "chunked+dp_only+fsdp": (
        {"attn_impl": "chunked", "attn_chunk": 1024},
        {"dp_only": True, "fsdp": True}),
    "seq_shard": ({"attn_seq_shard": True}, {}),
    "chunked+seq_shard": (
        {"attn_impl": "chunked", "attn_chunk": 1024, "attn_seq_shard": True}, {}),
    "chunked+last+seq_shard": (
        {"attn_impl": "chunked", "attn_chunk": 1024, "prefill_last_only": True,
         "attn_seq_shard": True}, {}),
    "chunked2k+last+seq_shard": (
        {"attn_impl": "chunked", "attn_chunk": 2048, "prefill_last_only": True,
         "attn_seq_shard": True}, {}),
    "chunked4k+last+seq_shard": (
        {"attn_impl": "chunked", "attn_chunk": 4096, "prefill_last_only": True,
         "attn_seq_shard": True}, {}),
    "chunked8k+last+seq_shard": (
        {"attn_impl": "chunked", "attn_chunk": 8192, "prefill_last_only": True,
         "attn_seq_shard": True}, {}),
}

TARGETS = {
    "minicpm-prefill": ("minicpm-2b", "prefill_32k"),
    "minicpm-train": ("minicpm-2b", "train_4k"),
    "whisper-train": ("whisper-medium", "train_4k"),
    "smollm-train": ("smollm-135m", "train_4k"),
    "mamba2-train": ("mamba2-2.7b", "train_4k"),
    "grok-train": ("grok-1-314b", "train_4k"),
}

#: the EDM target's variants (Subject11's config overridden)
EDM_VARIANTS = {
    "baseline": {},
    "bf16_dist": {"dist_dtype": "bfloat16"},
    "lib4": {"lib_block": 4},
    "lib2": {"lib_block": 2},
    "lib1": {"lib_block": 1},
    "tb4096": {"target_block": 4096},
    "lib4+tb4096": {"lib_block": 4, "target_block": 4096},
    "lib4+bf16": {"lib_block": 4, "dist_dtype": "bfloat16"},
}
#: JAX's knn_impl schedules, refused
EDM_REFUSED = ("unroll", "rebuild", "blocked")

TC_VARIANTS = {"bf16_moments": {"moment_dtype": "bfloat16"}}


def edm_variant(name: str) -> dict:
    """The EDM config overrides of a variant; a JAX ``knn_impl`` variant is
    refused with the reason."""
    if any(part.startswith(EDM_REFUSED) for part in name.split("+")):
        raise SystemExit(
            f"EDM variant {name!r}: knn_impl variants (unroll, rebuild, blocked:g) "
            "are XLA fusion schedules of one recurrence; eager PyTorch runs them "
            "as the same loop and the card through the same kernel, so the port "
            f"has none. Port variants: {', '.join(EDM_VARIANTS)}")
    if name not in EDM_VARIANTS:
        raise SystemExit(f"EDM variant {name!r}: one of {', '.join(EDM_VARIANTS)}")
    return EDM_VARIANTS[name]


def run(target: str, variant: str, multi_pod: bool = False, smoke: bool = False,
        device=None) -> dict:
    """The dry-run result of ``target`` under ``variant``."""
    if target == "edm":
        from repro_torch.configs.edm_datasets import SUBJECT11
        from repro_torch.launch.edm_dryrun import dryrun

        ds = dataclasses.replace(
            SUBJECT11, edm=dataclasses.replace(SUBJECT11.edm, **edm_variant(variant)))
        res = dryrun(ds, device=device)
        res["variant"] = variant
        return res
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import dry_cell, train_config_for

    if target not in TARGETS:
        raise SystemExit(f"target {target!r}: one of {', '.join(TARGETS)} or edm")
    arch, cell = TARGETS[target]
    parts = variant.split("&")
    if parts[0] not in LM_VARIANTS:
        raise SystemExit(f"variant {parts[0]!r}: one of {', '.join(LM_VARIANTS)}")
    cfg_kw, pol_kw = LM_VARIANTS[parts[0]]
    cfg = dataclasses.replace(get_config(arch, smoke=smoke), **cfg_kw)
    tc = train_config_for(arch)
    if len(parts) > 1:
        tc = dataclasses.replace(tc, **TC_VARIANTS[parts[1]])
    return dry_cell(arch, cell, multi_pod=multi_pod, cfg=cfg, policy_kw=pol_kw,
                    variant=variant, tc=tc)


def summary(target: str, variant: str, res: dict) -> str:
    rl = res["roofline"]
    peak = res["memory"]["peak_bytes_per_device"]
    return (f"{target} / {variant}: t_comp={rl['t_compute_s']:.4f} "
            f"t_mem={rl['t_memory_s']:.4f} t_coll={rl.get('t_collective_s', 0.0):.4f} "
            f"bottleneck={rl['bottleneck']} frac={rl['roofline_fraction']:.4f} "
            f"peak={'not measured' if peak is None else f'{peak / 2**30:.1f}GiB'}")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--target", required=True)
    ap.add_argument("--variant", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="an LM target's smoke config (a quick check)")
    ap.add_argument("--device", default=None,
                    help="the EDM target's device (default the card)")
    ap.add_argument("--out", default=None,
                    help="JSON path (default build/hillclimb/<target>__<variant>.json)")
    args = ap.parse_args(argv)
    res = run(args.target, args.variant, args.multi_pod, args.smoke, args.device)
    out = pathlib.Path(args.out) if args.out else RESULTS / f"{args.target}__{args.variant}.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(res, indent=2))
    print(summary(args.target, args.variant, res), f"-> {out}", flush=True)
    return res


if __name__ == "__main__":
    main()
