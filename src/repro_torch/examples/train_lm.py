"""Train a ~100M-class LM (smollm-135m family) for a few hundred steps
with the full stack: deterministic data stream, async checkpointing,
resilient step loop (sharded state under a world of ranks).

    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 300 [--device cpu]

The counterpart of the JAX package's ``examples/train_lm.py``: it drives
``repro_torch.launch.train.main`` with the same flags.  Runs the REDUCED
(smoke) config by default; ``--full`` for the real 135M config.  On the
card unless ``--device cpu``.
"""
import argparse
import tempfile


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--token-range", type=int, default=None,
                    help="tokens from [0, R): a stream with structure to learn")
    args = ap.parse_args(argv)

    from repro_torch.launch.train import main as train_main

    return train_main([
        "--arch", "smollm-135m",
        *([] if args.full else ["--smoke"]),
        "--steps", str(args.steps),
        "--batch", str(args.batch),
        "--seq", str(args.seq),
        "--ckpt-dir", tempfile.mkdtemp(prefix="train_lm_ckpt_"),
        "--save-every", "100",
        "--log-every", "20",
        *([] if args.device is None else ["--device", args.device]),
        *([] if args.token_range is None else ["--token-range", str(args.token_range)]),
    ])


if __name__ == "__main__":
    main()
