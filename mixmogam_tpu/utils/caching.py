"""Artifact caches (SURVEY.md §5 'Checkpoint / resume': the reference
caches kinship matrices keyed by dataset — kinship.save_kinship_to_file /
load_kinship_from_file pickles {k, accessions}; we key by genotype CONTENT
hash and add an eigendecomposition cache, since eigh is the other one-time
O(n^3) artifact worth reusing across traits/runs).

Robustness (review r5-cont, same treatment models/loco.py's eigen cache
got): every artifact writes via a PID-unique temp file + os.replace (a
kill mid-savez must not leave a truncated .npz — an 800 MB compressed K
takes minutes of host CPU, a wide kill window), and loads
tolerate a corrupt entry by recomputing instead of aborting."""

from __future__ import annotations

import logging
import os
from typing import List, Optional, Tuple

import numpy as np

_log = logging.getLogger("mixmogam_tpu.caching")


def _atomic_savez(path: str, compressed: bool = True, **arrays) -> None:
    tmp = f"{path}.tmp{os.getpid()}.npz"
    (np.savez_compressed if compressed else np.savez)(tmp, **arrays)
    os.replace(tmp, path)


def save_kinship_to_file(path: str, K: np.ndarray,
                         accessions: List[str]) -> None:
    """Reference-compatible named saver (npz instead of pickle: portable,
    no code execution on load); atomic write."""
    _atomic_savez(path if path.endswith(".npz") else path + ".npz",
                  k=np.asarray(K, dtype=np.float64),
                  accessions=np.array(accessions, dtype="U"))


def load_kinship_from_file(path: str) -> Tuple[np.ndarray, List[str]]:
    if not path.endswith(".npz") and os.path.exists(path + ".npz"):
        path = path + ".npz"
    with np.load(path, allow_pickle=False) as z:
        return z["k"], [str(a) for a in z["accessions"]]


def _key_path(cache_dir: str, kind: str, key: str) -> str:
    os.makedirs(cache_dir, exist_ok=True)
    return os.path.join(cache_dir, f"{kind}_{key}.npz")


def cached_kinship(gd, method: str = "ibs",
                   cache_dir: Optional[str] = None,
                   use_device: bool = True, scale: bool = True) -> np.ndarray:
    """Kinship with content-hash cache (reference flow §3.1: 'load cached
    OR calc_ibs_kinship'). A corrupt cache entry recomputes (and is
    overwritten) rather than aborting the run."""
    from mixmogam_tpu.ops import kinship as dk
    from mixmogam_tpu.oracle.kinship import scale_k

    key = f"{gd.content_hash()}_{method}{'_scaled' if scale else ''}"
    if cache_dir:
        p = _key_path(cache_dir, "kinship", key)
        if os.path.exists(p):
            try:
                K, acc = load_kinship_from_file(p)
                if acc == list(gd.accessions):
                    return K
            except Exception:
                _log.warning("unreadable kinship cache entry %s; "
                             "recomputing", p)
    K = dk.kinship(gd, method=method, use_device=use_device)
    if scale:
        K = scale_k(K)
    if cache_dir:
        save_kinship_to_file(_key_path(cache_dir, "kinship", key), K,
                             list(gd.accessions))
    return K


def cached_eigen(K: np.ndarray, cache_dir: Optional[str] = None,
                 key: Optional[str] = None) -> Tuple[np.ndarray, np.ndarray]:
    """eigh(K) (descending) with on-disk cache (uncompressed: U is
    ~800 MB f64 at n=10,240 and compression costs host CPU time per
    save for little gain on an orthonormal basis)."""
    import hashlib

    from mixmogam_tpu.ops.eigen import eigen_k

    p = None
    if cache_dir:
        if key is None:
            key = hashlib.sha256(
                np.ascontiguousarray(K, dtype=np.float64).tobytes()
            ).hexdigest()[:16]
        p = _key_path(cache_dir, "eigen", key)
        if os.path.exists(p):
            try:
                with np.load(p, allow_pickle=False) as z:
                    return z["phi"], z["U"]
            except Exception:
                _log.warning("unreadable eigen cache entry %s; "
                             "recomputing", p)
    phi, U = eigen_k(K, host=True)
    phi = np.asarray(phi, dtype=np.float64)
    U = np.asarray(U, dtype=np.float64)
    if p:
        _atomic_savez(p, compressed=False, phi=phi, U=U)
    return phi, U
