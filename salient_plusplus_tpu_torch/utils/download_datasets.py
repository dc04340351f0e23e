"""Pre-partitioned dataset downloader (counterpart of the JAX package's
``utils/download_datasets.py``; needs network access).

The reference's utils/download_datasets_fast.py (:23-24) pulls
pre-partitioned, VIP-reordered OGB datasets from a public bucket, so that
users skip the partitioning and reordering. The same workflow here:

  python -m salient_plusplus_tpu_torch.utils.download_datasets \
      ogbn-products 8 --out datasets/

Each SALIENT++-format archive is converted as it arrives
(``data/salient_import.py``) into ``<name>-reordered-k{k}``, which the
driver trains from. ``SPTPU_DATASET_BUCKET`` points at another bucket (any
URL ``urllib`` opens, ``file://`` included). Without network access the
command fails within its timeout with an actionable message.
"""

from __future__ import annotations

import argparse
import os
import sys
import tarfile
import tempfile
import urllib.error
import urllib.request

# the reference's bucket layout (download_datasets_fast.py:23-24): one
# archive per (dataset, number of partitions)
BUCKET = os.environ.get(
    "SPTPU_DATASET_BUCKET",
    "https://salient-datasets-ae.s3.amazonaws.com")
KNOWN = ("ogbn-arxiv", "ogbn-products", "ogbn-papers100M", "MAG240")


def archive_url(name: str, k: int) -> str:
    return f"{BUCKET}/{name}-{k}.tar.gz"


def download_partitioned(name: str, k: int, out_root: str,
                         timeout: float = 30.0) -> str:
    """Download and convert one pre-partitioned dataset; returns the saved
    dataset's path. Raises RuntimeError with an actionable message when
    the archive cannot be fetched."""
    if name not in KNOWN:
        raise ValueError(f"unknown dataset {name!r}; known: {KNOWN}")
    url = archive_url(name, k)
    os.makedirs(out_root, exist_ok=True)
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp, \
                tempfile.NamedTemporaryFile(suffix=".tar.gz") as tmp:
            while True:
                chunk = resp.read(1 << 22)
                if not chunk:
                    break
                tmp.write(chunk)
            tmp.flush()
            with tempfile.TemporaryDirectory() as td:
                with tarfile.open(tmp.name) as tar:
                    tar.extractall(td, filter="data")
                src = os.path.join(td, f"{name}-{k}")
                if not os.path.isdir(src):
                    entries = os.listdir(td)
                    src = os.path.join(td, entries[0]) if entries else td
                from ..data.salient_import import import_salient_partitioned

                return import_salient_partitioned(
                    src, f"{name}-reordered-k{k}", out_root)
    except (urllib.error.URLError, OSError, TimeoutError) as e:
        raise RuntimeError(
            f"cannot download {url}: {e}. This environment likely has no "
            f"network egress — obtain the archive elsewhere and convert it "
            f"with salient_plusplus_tpu_torch.data.salient_import, or "
            f"ingest raw OGB data via data/ogb.py.") from e


def main(argv=None):
    p = argparse.ArgumentParser(prog="download_datasets")
    p.add_argument("dataset", choices=KNOWN)
    p.add_argument("k", type=int, help="number of partitions")
    p.add_argument("--out", default="datasets")
    args = p.parse_args(argv)
    try:
        path = download_partitioned(args.dataset, args.k, args.out)
    except RuntimeError as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 1
    print(path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
