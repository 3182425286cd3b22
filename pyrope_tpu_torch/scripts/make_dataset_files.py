"""Write the dataset files the file-backed bench rows read.

The twin of ``scripts/make_dataset_files.py``, byte for byte the same files:
the clustered synthetic corpora written in the two formats the reference's
loaders read (fvecs: an int32 dim then float32 LE per record; GloVe text:
``token v1..vN`` a line, 6 decimals), into DIR:

    clustered100k.fvecs, clustered100k_queries.fvecs   (100k x 128, 1024 queries)
    glove50k.txt, glove50k_queries.fvecs               (50k x 100, 1024 queries)

    python -m pyrope_tpu_torch.scripts.make_dataset_files DIR

then, on the card:

    python -m pyrope_tpu_torch.scripts.bench --configs ivf100k_fvecs_file \\
        --base-fvecs DIR/clustered100k.fvecs --query-fvecs DIR/clustered100k_queries.fvecs
    python -m pyrope_tpu_torch.scripts.bench --configs ivf_glove_file \\
        --glove DIR/glove50k.txt --query-fvecs DIR/glove50k_queries.fvecs

numpy only: it makes no tensor and touches no device.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

from pyrope_tpu_torch.utils.datasets import (
    synthetic_clustered,
    synthetic_clustered_queries,
    write_fvecs,
)


def write_glove_txt(path: Path, vecs: np.ndarray) -> None:
    """GloVe-format text: `token v1..vN` per line (6 decimals, as the
    published GloVe files)."""
    with open(path, "w", encoding="utf-8") as f:
        for i, v in enumerate(vecs):
            f.write(f"w{i} " + " ".join(f"{x:.6f}" for x in v) + "\n")


def write_dataset_files(out, n_base: int = 100_000, n_glove: int = 50_000,
                        n_queries: int = 1024) -> dict:
    """The four files under ``out`` (created if missing), at the JAX
    script's sizes unless told otherwise; returns their paths by name."""
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    paths = {name: out / name for name in ("clustered100k.fvecs", "clustered100k_queries.fvecs",
                                           "glove50k.txt", "glove50k_queries.fvecs")}
    write_fvecs(paths["clustered100k.fvecs"], synthetic_clustered(n_base, 128, n_clusters=100))
    write_fvecs(paths["clustered100k_queries.fvecs"],
                synthetic_clustered_queries(n_queries, 128, n_clusters=100))
    write_glove_txt(paths["glove50k.txt"], synthetic_clustered(n_glove, 100, n_clusters=100))
    write_fvecs(paths["glove50k_queries.fvecs"],
                synthetic_clustered_queries(n_queries, 100, n_clusters=100))
    for path in paths.values():
        print(f"wrote {path} ({path.stat().st_size / 2**20:.1f} MB)", file=sys.stderr)
    return paths


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        raise SystemExit(__doc__)
    write_dataset_files(argv[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
