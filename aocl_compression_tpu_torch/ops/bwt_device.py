"""Burrows-Wheeler transform as device tensor ops (forward and inverse).

The port of aocl_compression_tpu/ops/bwt_device.py: bzip2's block sort
(reference blocksort.c) by prefix doubling over the cyclic rotations of
the block. Each round ranks every rotation by the pair (rank of its first
k symbols, rank of the k symbols after them) with one sort; ceil(log2 n)
rounds give the rotation order. The inverse rebuilds the block from (L,
I) by pointer doubling over the last-to-first map. No path of the port
runs the inverse (bzip2 decodes on the host C++ in both packages); it is
kept and held to the JAX package's.

Sorts: the JAX package sorts [rank, rank2, idx] with num_keys=2, which is
unstable, but only the dense ranks it derives are defined, and they do not
depend on the order of ties. So each round is one torch.sort of the unique
int64 key rank << 40 | rank2 << 20 | idx. The 20-bit fields hold because
a bzip2 block is at most 900,000 < 2^20 bytes after RLE1. The final order
is the one lax.sort([row_of, idx, idx], num_keys=2) defines: by rank, ties
by position. The rounds stop once all n ranks are distinct; later rounds
would leave them unchanged.
"""

from __future__ import annotations

import numpy as np
import torch

_FIELD = 20
_MASK = (1 << _FIELD) - 1
MAX_BLOCK = 1 << _FIELD


def _ceil_log2(n: int) -> int:
    return int(np.ceil(np.log2(max(n, 2))))


def _rank_from_sorted(sk1, sk2, order, n: int):
    """Dense ranks for (k1, k2) pairs already in sorted order, returned in
    position order (order[j] is the position of the j-th pair)."""
    new = torch.ones(n, dtype=torch.int64, device=sk1.device)
    new[0] = 0
    if n > 1:
        new[1:] = ((sk1[1:] != sk1[:-1]) | (sk2[1:] != sk2[:-1])).long()
    ranks_sorted = torch.cumsum(new, 0)
    # unsort: the JAX package's sort keyed by position is a scatter by it
    return torch.empty_like(ranks_sorted).scatter_(0, order, ranks_sorted)


def bwt_forward_block(data_u8: torch.Tensor, n: int):
    """BWT of one block (cyclic rotations): data_u8 (n,) uint8. Returns
    (L (n,) uint8, I): L[r] is the byte before the rotation of row r, I the
    row of the rotation that starts at position 0."""
    if n > MAX_BLOCK:
        raise ValueError(f"bwt: block of {n} bytes exceeds the 2^20-byte "
                         f"limit of the packed sort key")
    dev = data_u8.device
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    rank = data_u8.to(torch.int64)   # round 0: rank = byte value
    k = 1
    while k < n:
        rank2 = torch.roll(rank, -k)  # rank of the rotation at i + k
        skey = torch.sort((rank << (2 * _FIELD)) | (rank2 << _FIELD)
                          | idx).values
        rank = _rank_from_sorted(skey >> (2 * _FIELD),
                                 (skey >> _FIELD) & _MASK, skey & _MASK, n)
        k <<= 1
        if k < n and int(rank.max()) == n - 1:
            break  # all ranks distinct: later rounds keep them
    # rows by final rank, ties (a periodic block) by position
    start = torch.sort((rank << _FIELD) | idx).values & _MASK
    prev = torch.where(start == 0, n - 1, start - 1)
    L = data_u8[prev]
    I = int(torch.argmin(start))
    return L, I


def bwt_inverse_block(L_u8: torch.Tensor, I: int, n: int) -> torch.Tensor:
    """Invert (L, I) to the original block (n,) uint8 by rank sorts and
    pointer doubling."""
    dev = L_u8.device
    L = L_u8.to(torch.int64)
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    # T[j] = position in L of the j-th smallest (L, idx) pair; LF is its
    # inverse permutation (the last-to-first map)
    T = torch.sort(L * n + idx).indices
    LF = torch.empty_like(T).scatter_(0, T, idx)
    # s[n-1-k] = L[p_k] with p_0 = I, p_{k+1} = LF[p_k]: seq[k] = LF^k(I)
    # for k < filled; each round appends P(seq[:filled]) with P =
    # LF^filled, then squares P
    seq = torch.zeros(n, dtype=torch.int64, device=dev)
    seq[0] = I
    P = LF
    filled = 1
    for _ in range(_ceil_log2(n)):
        if filled >= n:
            break
        ext = P[seq]
        shift_in = torch.where(idx >= filled, torch.roll(ext, filled), seq)
        seq = torch.where(idx < 2 * filled, shift_in, seq)
        P = P[P]
        filled *= 2
    return L_u8[seq].flip(0)


def bwt(data: bytes, device):
    """Forward BWT of one block on `device`: (L bytes, I)."""
    arr = torch.from_numpy(np.frombuffer(data, np.uint8).copy()).to(device)
    L, I = bwt_forward_block(arr, len(data))
    return L.cpu().numpy().tobytes(), I


def ibwt(L: bytes, I: int, device) -> bytes:
    """Inverse BWT of one block on `device`."""
    arr = torch.from_numpy(np.frombuffer(L, np.uint8).copy()).to(device)
    return bwt_inverse_block(arr, I, len(L)).cpu().numpy().tobytes()
