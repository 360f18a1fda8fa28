"""The work of one attention forward or backward, from its shape and mask:
the formulas that both ``chip_smoke.py``'s bounds and
``launch.graph_analysis`` read.

Forward: q and the first ``kv_valid_len`` rows of k and v (all Sk without
it) are read once and out (and, with the log-sum-exp, lse) written once;
every (q, k) pair the mask lets through takes 2 (D + Dv) operations a
head (S = q k^T and P v).  Backward: q, k, v, out, dout and lse read once
and dq, dk, dv written once; 2 (3 D + 2 Dv) operations a visible pair and
head (S = q k, dP = dout v, dv += P dout, dq += dS k, dk += dS q: five
products where the forward has two).  The operations are those of the
matrix products (what a FLOP counter charges for the same attention); a
float32 call runs each of them as three TF32 products (3xTF32), which the
card's bound charges, not this count."""

from __future__ import annotations

import numpy as np

BWD_LAUNCHES = 3     # delta, dk / dv, dq (two without keys)


def visible_pairs(Sq: int, Sk: int, mask: str, window: int, kvl) -> int:
    """(q, k) pairs the mask lets through, for one (b, h): query row i sits
    at position i (i + kv_valid_len - Sq with ``kv_valid_len``) and sees
    the keys below ``kv_valid_len`` (all Sk without it), up to its own
    position unless the mask is ``none``, and no further back than
    ``window`` positions under ``window``."""
    valid = Sk if kvl is None else kvl
    p = np.arange(Sq, dtype=np.int64) + (0 if kvl is None else kvl - Sq)
    hi = (np.clip(np.minimum(p + 1, valid), 0, None) if mask != "none"
          else np.full_like(p, valid))
    lo = (np.clip(p - window + 1, 0, None) if mask == "window"
          else np.zeros_like(p))
    return int(np.clip(hi - lo, 0, None).sum())


def forward_work(B, Sq, Sk, H, KV, D, Dv, mask, window, kvl, itemsize: int,
                 lse: bool = False) -> tuple:
    """(operations, bytes) of one forward launch; ``itemsize`` the bytes of
    an element of q, k, v and out; ``lse`` adds its (B, H, Sq) float32."""
    valid = Sk if kvl is None else kvl          # the key rows it must read
    nbytes = itemsize * (B * Sq * H * (D + Dv) + B * valid * KV * (D + Dv))
    if lse:
        nbytes += 4 * B * H * Sq
    ops = 2 * B * H * (D + Dv) * visible_pairs(Sq, Sk, mask, window, kvl)
    return ops, nbytes


def backward_work(B, Sq, Sk, H, KV, D, Dv, mask, window, kvl,
                  itemsize: int) -> tuple:
    """(operations, bytes) of one backward call (its three launches).  Per
    query row and head q and dq (D each), out and dout (Dv each); per
    visible key row and kv head k and dk (D each), v and dv (Dv each); lse
    float32."""
    valid = Sk if kvl is None else kvl
    nbytes = (itemsize * (B * Sq * H * (D + Dv) * 2
                          + B * valid * KV * (D + Dv) * 2)
              + 4 * B * H * Sq)
    ops = 2 * B * H * (3 * D + 2 * Dv) * visible_pairs(Sq, Sk, mask, window,
                                                       kvl)
    return ops, nbytes


def _dims(q, k, v):
    B, Sq, H, D = q.shape
    return B, Sq, k.shape[1], H, k.shape[2], D, v.shape[3]


def fwd_op_work(q, k, v, mask_kind, window, kv_valid_len) -> dict:
    """The work of one ``repro_torch::flash_attention`` call (tensors or
    fakes: shapes only)."""
    ops, nbytes = forward_work(*_dims(q, k, v), mask_kind, window,
                               kv_valid_len, q.element_size())
    return dict(flops=ops, bytes=nbytes, launches=1)


def fwd_lse_op_work(q, k, v, mask_kind, window, kv_valid_len) -> dict:
    """... of one ``repro_torch::flash_attention_fwd_lse`` call."""
    ops, nbytes = forward_work(*_dims(q, k, v), mask_kind, window,
                               kv_valid_len, q.element_size(), lse=True)
    return dict(flops=ops, bytes=nbytes, launches=1)


def bwd_op_work(q, k, v, out, lse, dout, mask_kind, window,
                kv_valid_len) -> dict:
    """... of one ``repro_torch::flash_attention_bwd`` call."""
    dims = _dims(q, k, v)
    ops, nbytes = backward_work(*dims, mask_kind, window, kv_valid_len,
                                q.element_size())
    return dict(flops=ops, bytes=nbytes,
                launches=BWD_LAUNCHES if dims[2] > 0 else BWD_LAUNCHES - 1)
