"""Write the acceptance scene's truth cloud as an npz, so that programs
without JAX (the PyTorch port) can read the exact cloud the acceptance runs
drew.

The cloud is ``scripts/acceptance_full.py``'s ``build_truth_and_cams``
truth: ``make_random_cloud(jax.random.key(0), TRUTH_N, extent=1.0,
scale_range=(0.004, 0.02))``, written by ``splatpu.io.checkpoint.save_cloud``
(every row alive, so compaction leaves it as drawn).

Usage:
    python scripts/export_acceptance_truth.py [--truth-n 120000]
        [--out runs/acceptance_truth/truth_n120000.npz]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--truth-n", type=int, default=None)
    p.add_argument("--out", default=None,
                   help="default: runs/acceptance_truth/truth_n<N>.npz")
    args = p.parse_args(argv)

    import acceptance_full as acc

    acc.TRUTH_N = args.truth_n or acc.TRUTH_N

    import jax
    import numpy as np

    from splatpu.io.checkpoint import save_cloud

    truth, _ = acc.build_truth_and_cams(jax, np)
    out = Path(args.out or f"runs/acceptance_truth/truth_n{acc.TRUTH_N}.npz")
    save_cloud(out, truth)
    print(f"wrote {out} ({acc.TRUTH_N} Gaussians)")


if __name__ == "__main__":
    main()
