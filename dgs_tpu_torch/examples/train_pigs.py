"""Runnable PIGS-style training demo (config 4's problem at any size).

Fits a Gaussian field to a manufactured periodic Poisson problem with a PDE
residual + data loss, backpropagating through values, means and (through
the scale / rotation chain) covariances; models.pigs.train with the tiled
path's capacities planned from the initial field.  The counterpart of
examples/train_pigs.py, with the same flags and ``--device`` (default the
card):

    python -m dgs_tpu_torch.examples.train_pigs --gaussians 2000 --steps 200
    python -m dgs_tpu_torch.examples.train_pigs --device cpu --gaussians 64 \\
        --steps 3 --collocation 256

For several ranks, see dgs_tpu_torch.parallel.mesh (make_sharded_pigs_step,
make_model_sharded_pigs_step) and dgs_tpu_torch.tools.scaling_bench.
"""

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gaussians", type=int, default=2000)
    ap.add_argument("--dims", type=int, default=2, choices=(1, 2, 3))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--collocation", type=int, default=4096)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--method", default="tiled",
                    choices=("tiled", "pallas", "dense"))
    ap.add_argument("--log-every", type=int, default=25)
    ap.add_argument("--metrics", default=None,
                    help="JSONL metrics path (default: standard output)")
    ap.add_argument("--checkpoint", default=None,
                    help="save the final TrainState to this file")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    from dgs_tpu_torch.config import SamplerConfig
    from dgs_tpu_torch.models import pigs
    from dgs_tpu_torch.utils.metrics import JsonlLogger

    logger = (JsonlLogger(args.metrics) if args.metrics
              else JsonlLogger(stream=sys.stdout))
    try:
        state, history = pigs.train(
            SamplerConfig(), P=args.gaussians, D=args.dims,
            steps=args.steps, n_collocation=args.collocation,
            learning_rate=args.lr, method=args.method,
            log_every=args.log_every, logger=logger, device=args.device)
    finally:
        logger.close()
    if args.checkpoint:
        from dgs_tpu_torch.utils import checkpoint

        checkpoint.save(args.checkpoint, state)
        print(f"saved TrainState to {args.checkpoint}")
    last = history[-1]
    print(f"final loss: {last['loss']:.4f} (pde {last['pde']:.4f}, "
          f"data {last['data']:.6f})")


if __name__ == "__main__":
    main()
