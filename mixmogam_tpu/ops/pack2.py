"""2-bit genotype codes: pack on host (native/fast_parse.cpp or numpy),
unpack ON DEVICE.

Genotype dosages fit in 2 bits (0..2 + missing), so the resident genome
(models.resident) holds 4 samples per byte and unpacks each tile with a
few shift/mask ops in front of the rotation matmul. Streamed paths send
raw int8: packing on the host costs more than the 4x smaller copy saves
over PCIe (PERF.md, Findings). Codes: 0/1/2 = dosage, 3 = missing (-1), sample k at bits 2k (matches
native.pack_2bit / fast_parse.cpp)."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=("n",))
def unpack_2bit_device(packed: jnp.ndarray, n: int) -> jnp.ndarray:
    """(m, ceil(n/4)) uint8 -> (m, n) int8 with code 3 -> -1 (missing)."""
    m = packed.shape[0]
    shifts = (jnp.arange(4, dtype=jnp.uint8) * 2)[None, None, :]
    codes = (packed[:, :, None] >> shifts) & jnp.uint8(3)   # (m, rb, 4)
    codes = codes.reshape(m, -1)[:, :n].astype(jnp.int8)
    return jnp.where(codes == 3, jnp.int8(-1), codes)

