"""Storage plane: uniform access to local paths and object stores.

The reference suite talks to S3 directly through boto3 in every script and
auto-detects the CSV delimiter with ``csv.Sniffer`` over the first 1 KiB
(reference: Pycyto_pertime.py:18-26 and its clones in Normalize_CP_ami.py,
Feature_select_cosine_ami.py, Inuction_Score_hit.py, MaxProjection.py).
Here one fsspec-backed layer serves every stage, so the whole framework runs
identically against ``s3://``, ``gs://``, ``memory://`` or plain local paths
— local/in-memory filesystems are what the test-suite's fake plates use.
"""

from __future__ import annotations

import csv
import io
import os
import posixpath
from typing import Iterator

import fsspec
import pandas as pd

__all__ = [
    "open_file",
    "read_bytes",
    "write_bytes",
    "read_csv_sniffed",
    "write_csv",
    "list_prefix",
    "exists",
    "join",
]


def _fs_and_path(path: str):
    """Resolve an fsspec filesystem + normalized path for ``path``."""
    if "://" in path:
        protocol, rest = path.split("://", 1)
        fs = fsspec.filesystem(protocol)
        return fs, path
    return fsspec.filesystem("file"), os.path.abspath(path)


def join(*parts: str) -> str:
    """Join path segments; keeps URL-style paths POSIX-separated."""
    if "://" in parts[0]:
        head, rest = parts[0].split("://", 1)
        return head + "://" + posixpath.join(rest, *parts[1:])
    return posixpath.join(*parts)


def open_file(path: str, mode: str = "rb"):
    fs, p = _fs_and_path(path)
    if "w" in mode or "a" in mode:
        parent = posixpath.dirname(p.split("://", 1)[-1])
        if parent:
            try:
                fs.makedirs(parent, exist_ok=True)
            except Exception:
                pass
    return fs.open(p, mode)


def read_bytes(path: str) -> bytes:
    with open_file(path, "rb") as f:
        return f.read()


def write_bytes(path: str, data: bytes) -> None:
    with open_file(path, "wb") as f:
        f.write(data)


def exists(path: str) -> bool:
    fs, p = _fs_and_path(path)
    return fs.exists(p)


def list_prefix(path: str) -> Iterator[str]:
    """List files under a prefix (recursive), returning full URLs/paths."""
    fs, p = _fs_and_path(path)
    protocol = path.split("://", 1)[0] + "://" if "://" in path else ""
    for entry in fs.find(p):
        yield protocol + entry if protocol and "://" not in entry else entry


def discover_folders(path: str, tokens: list[str]) -> list[str]:
    """First folder level under ``path`` whose name contains any token —
    the reference's plate-folder discovery (Feature_extraction_opt.py:21-36,
    ``list_dmso_main_folders``): walk each object key's path segments and
    collect the shallowest matching prefix."""
    folders: set[str] = set()
    base = path.split("://", 1)[-1].strip("/")
    for key in list_prefix(path):
        rel = key.split("://", 1)[-1]
        parts = rel.strip("/").split("/")
        for i in range(1, len(parts)):
            if any(token in parts[i - 1] for token in tokens):
                folders.add("/".join(parts[:i]) + "/")
                break
    return sorted(folders)


def read_csv_sniffed(path: str, **kwargs) -> pd.DataFrame:
    """Read a CSV whose delimiter may be ``,`` or ``;``.

    Reproduces the reference's ``read_csv_from_s3`` contract
    (Pycyto_pertime.py:18-26): sniff the dialect over the first 1024 bytes
    restricted to ``;,``, then parse with pandas.
    """
    raw = read_bytes(path)
    text = raw.decode("utf-8")
    sample = text[:1024]
    try:
        dialect = csv.Sniffer().sniff(sample, delimiters=";,")
        sep = dialect.delimiter
    except csv.Error:
        sep = ","
    return pd.read_csv(io.StringIO(text), sep=sep, **kwargs)


def write_csv(df: pd.DataFrame, path: str, index: bool = False) -> None:
    buf = io.StringIO()
    df.to_csv(buf, index=index)
    write_bytes(path, buf.getvalue().encode("utf-8"))
