"""Train a HAN/GAT model on a named dataset (the ex_acm3025.py equivalent).

    python scripts/train.py --dataset acm
    python scripts/train.py --dataset dblp --set train.epochs=150
    python scripts/train.py --dataset imdb --set model.impl=dense
    python scripts/train.py --dataset ppi          # inductive GAT

Prints per-epoch metrics (train/val loss+acc and mean semantic attention,
matching the reference's epoch log, ex_acm3025.py:220-223) and final test
accuracy + KNN/KMeans embedding scores (jhyexp.py semantics).
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))


def main():
    from han_jax.utils.cache import setup_compile_cache

    setup_compile_cache()

    from han_jax.train import trainer
    from han_jax.train.config import parse_cli

    cfg = parse_cli()
    # every dataset — including inductive PPI — goes through the same front
    # door; trainer.run() routes on the dataset type
    result = trainer.run(cfg)
    print(result)


if __name__ == "__main__":
    main()
