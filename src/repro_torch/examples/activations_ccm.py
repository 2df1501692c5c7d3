"""Causal inference of NETWORK dynamics at single-neuron resolution: the
paper's technique applied to an artificial neural network.

    PYTHONPATH=src python -m repro_torch.examples.activations_ccm [--device cpu]

The counterpart of the JAX package's ``examples/activations_ccm.py``.
Trains a small LM (smollm-135m smoke) for 40 steps, records the
activation time series of individual hidden units ("neurons") -- the
residual stream after every block, across the sequence axis -- and runs
the CCM pipeline on them: a causal map across layers, the paper's
workflow with the zebrafish brain swapped for an ANN.  Runs on the card
(the flash kernel in training, ``knn_topk`` and ``ccm_lookup`` in the
CCM) unless ``--device cpu``.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.core.pipeline import run_causal_inference
from repro_torch.core.types import EDMConfig
from repro_torch.data.pipeline import TokenStream
from repro_torch.launch.steps import TrainState, make_train_step
from repro_torch.models import transformer as T


@torch.no_grad()
def record_neurons(params, cfg, batch, n_per_layer=8):
    """Activation time series: residual-stream units across the sequence
    axis (time = token position, like the paper's 2 Hz frames) ->
    (layers * n_per_layer, S) float32, layer-major."""
    x = T._embed(params.embed, cfg, T._tokens(params, batch["tokens"]))
    acts = []
    for blk in params.blocks:  # JAX scans over the stacked blocks
        x, _ = T._dense_block_fwd(blk, cfg, x)
        acts.append(x[0, :, :n_per_layer].float())  # (S, n) units of example 0
    acts = torch.stack(acts)  # (layers, S, n)
    L_, S, n = acts.shape
    return acts.transpose(1, 2).reshape(L_ * n, S).cpu().numpy().astype(np.float32)


def active_series(ts: np.ndarray) -> np.ndarray:
    """The JAX example's preprocessing: 1e-3 N(0, 1) noise (numpy seed 0),
    the units whose std exceeds 1e-4, z-scored."""
    ts = ts + 1e-3 * np.random.default_rng(0).standard_normal(ts.shape).astype(np.float32)
    keep = ts.std(axis=1) > 1e-4  # active neurons only, like the paper
    return (ts[keep] - ts[keep].mean(1, keepdims=True)) / ts[keep].std(1, keepdims=True)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--seq", type=int, default=512)
    args = ap.parse_args(argv)
    cfg = get_config("smollm-135m", smoke=True)
    tc = TrainConfig(lr=2e-3, warmup_steps=5, total_steps=args.steps, remat=False)
    dev = torch.device(args.device)
    state = TrainState.create(cfg, tc, device=dev)
    step = make_train_step(cfg, tc, device=dev)
    stream = TokenStream(cfg.vocab_size, 2, args.seq, seed=0)

    print(f"[1/3] training a small LM for {args.steps} steps...")
    losses = []
    for i in range(args.steps):
        state, m = step(state, stream.batch_at(i))
        losses.append(float(m["loss"]))
    print(f"      final loss {losses[-1]:.3f}")

    print(f"[2/3] recording per-neuron activation time series (S={args.seq})...")
    ts = active_series(record_neurons(state.params, cfg, stream.batch_at(99)))
    print(f"      {ts.shape[0]} active neurons x {ts.shape[1]} time steps")

    print("[3/3] CCM causal map across neurons...")
    out = run_causal_inference(ts, EDMConfig(E_max=6), device=dev)
    rho = np.array(out.rho)
    np.fill_diagonal(rho, 0)
    strongest = np.unravel_index(np.argmax(rho), rho.shape)
    print(f"      mean |rho| = {np.abs(rho).mean():.3f}; "
          f"strongest causal link: neuron {strongest[1]} -> neuron {strongest[0]} "
          f"(rho={rho[strongest]:.3f})")
    print("      causal map computed: the paper's pipeline, ANN edition.")
    return {"losses": losses, "ts": ts, "optE": np.asarray(out.optE),
            "rho": np.asarray(out.rho), "state": state}


if __name__ == "__main__":
    main()
