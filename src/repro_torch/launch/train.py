"""Training launcher of the port: --arch <id> on one device or a mesh of
ranks, with sharded state, async checkpointing and the resilient step
loop.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --steps 300 --batch 8 --seq 512 --smoke --ckpt-dir "$TMPDIR/ckpt"

The counterpart of the JAX package's ``launch/train.py``, with its flags
and defaults (the checkpoint directory under the temporary directory),
plus ``--device`` (default the card; ``--device cpu`` runs the plain
versions on the CPU) and ``--token-range`` (the stream's tokens from
[0, R): a stream with structure to learn).

One process is one device, as before.  Under the EDM_* contract
(``EDM_COORDINATOR`` / ``EDM_NUM_PROCESSES`` / ``EDM_PROCESS_ID``, one
process a rank; ``runtime/platform.py::init_distributed``: NCCL with a
card a rank, gloo on the CPU) the ranks form ``make_local_mesh``
(all data-parallel, as JAX's ``make_cpu_mesh``), the state is placed by
``auto_policy`` (FSDP above ~2 B parameters), created shard by shard
(``TrainState.create(policy=)``: no rank holds the whole model), and
every step's batch (tokens, and whisper's audio frames or the vlm's
image patches) by its batch specs.  Every family runs so (``--arch
dbrx-132b``, ``mamba2-2.7b``, ``zamba2-7b``, ``whisper-medium``,
``llama-3.2-vision-11b``).  A run resumes from the
latest checkpoint in ``--ckpt-dir``, whatever world wrote it (JAX's
"elastic: any mesh").
``--production-mesh`` builds the 16 x 16 mesh over a world of exactly
256 ranks and refuses any other (``launch/mesh.py``).
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.data.pipeline import TokenStream
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.launch.steps import TrainState, make_train_step
from repro_torch.runtime.device import resolve_device
from repro_torch.runtime.fault import ResilientLoop
from repro_torch.runtime.platform import (distributed_spec_from_env, init_distributed,
                                          rank_device)
from repro_torch.sharding import policy as POL


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, default="smollm-135m")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_ckpt"))
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; cpu: the plain versions)")
    ap.add_argument("--token-range", type=int, default=None,
                    help="draw the stream's tokens from [0, R) (default: the "
                    "whole vocabulary, JAX's stream)")
    args = ap.parse_args(argv)

    spec = distributed_spec_from_env()
    if args.production_mesh and spec is None:
        make_production_mesh()  # refuses a world of one, naming its shape
    dev = resolve_device(args.device) if spec is None else rank_device(spec, args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    tc = TrainConfig(lr=args.lr, total_steps=args.steps,
                     warmup_steps=max(1, args.steps // 20))
    if spec is None:
        state = TrainState.create(cfg, tc, device=dev)
    else:
        init_distributed(spec, device=args.device)
        mesh = (make_production_mesh(device=dev) if args.production_mesh
                else make_local_mesh(device=dev))
        policy = POL.auto_policy(cfg, mesh)
        # created shard by shard: no rank holds the whole model
        state = TrainState.create(cfg, tc, device=dev, policy=policy)
        print(f"rank {spec['process_id']}/{spec['num_processes']}: mesh "
              f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}, fsdp {policy.fsdp}, "
              f"placement {state.params.placement_record}", flush=True)
    step_fn = make_train_step(cfg, tc, device=dev)

    extra = {}
    if cfg.family == "audio":
        extra["audio"] = ((args.batch, cfg.n_frontend_tokens, cfg.d_model), np.float32)
    if cfg.family == "vlm":
        extra["image_embeds"] = ((args.batch, cfg.n_frontend_tokens, cfg.d_model),
                                 np.float32)
    stream = TokenStream(args.token_range or cfg.vocab_size, args.batch, args.seq,
                         seed=tc.seed, extra_specs=extra)
    ckpt = CheckpointManager(args.ckpt_dir, keep_last=2)

    # resume if a checkpoint exists
    start = 0
    restored = ckpt.restore_latest(state, dev)
    if restored[0] is not None:
        start, state = restored
        print(f"resumed from step {start}", flush=True)

    def logging_step(state, batch):
        t0 = time.time()
        state, metrics = step_fn(state, batch)
        step = int(state.step)
        if step % args.log_every == 0 or step == 1:
            print(
                f"step {step:5d} loss={float(metrics['loss']):.4f} "
                f"gnorm={float(metrics['grad_norm']):.3f} dt={time.time()-t0:.3f}s",
                flush=True,
            )
        return state, metrics

    loop = ResilientLoop(logging_step, ckpt, save_every=args.save_every)
    state, step, metrics = loop.run(state, stream.batch_at, n_steps=args.steps,
                                    start_step=start, device=dev)
    final = "n/a" if metrics is None else f"{metrics['loss']:.4f}"
    print(f"done at step {step}; final loss {final}", flush=True)
    return state, step, metrics


if __name__ == "__main__":
    main()
