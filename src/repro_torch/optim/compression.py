"""Int8 error-feedback gradient compression for the data-parallel
all-reduce (from ``repro.optim.compression``).

Gradients cross the data-parallel group as int8 codes with one float32
scale per 128 elements, and an error-feedback residual carries what
quantization lost into the next round, so the noise does not bias the
optimizer.  :func:`int8_psum`, over a process group
(``parallel.collectives``):

  1. chunk-quantize ``g + err`` to int8;
  2. ``all_to_all`` the codes and scales (the reduce-scatter's exchange);
  3. dequantize the received rows and sum them in float32, in rank order
     (each dequantize-and-add a fused multiply-add with one rounding, as
     XLA compiles the reference's, so the sums are bitwise the jitted
     reference's);
  4. requantize the reduced shard;
  5. ``all_gather`` the shards' codes and scales; dequantize;
  6. the new residual is ``g + err`` less what this rank sent (again
     one fused multiply-add).

Each device sends and receives about N int8 bytes in each of the two
exchanges (plus N/32 bytes of scales), against the ~4N of a float32 ring
all-reduce.  The passes are plain tensor code, as the reference leaves
them to XLA.  Every step is elementwise or a sum in a fixed order, so a
call gives the same bits on the card as on the CPU.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from ..kernels import ref
from ..models.common import map_tree, tree_paths, tree_unflatten
from ..parallel import collectives

__all__ = ["CHUNK", "compressed_grad_psum", "flatten_tree", "int8_psum",
           "tree_size", "unflatten_tree"]

CHUNK = 128  # elements per quantization scale
_FMA_SLICE = 1 << 26  # elements of one float64 slice of _add_product


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (..., K*CHUNK) → (int8 codes of x's shape, float32 scales (..., K)).

    The scale is ``amax * float32(1/127)`` (``kernels.ref.int8_quantize``):
    the reference writes ``amax / 127.0``, and XLA rewrites a division by
    a constant as that multiply under ``jax.jit``, where the reference
    always runs this (inside ``shard_map``); an eager division can differ
    in the last bit."""
    shp = x.shape
    q, scale = ref.int8_quantize(
        x.reshape(shp[:-1] + (shp[-1] // CHUNK, CHUNK)).float(), dim=-1)
    return q.reshape(shp), scale[..., 0]


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    shp = q.shape
    qr = q.reshape(shp[:-1] + (shp[-1] // CHUNK, CHUNK)).float()
    return (qr * scale[..., None]).reshape(shp)


def _add_product(acc: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                 sign: float = 1.0) -> torch.Tensor:
    """``acc + sign * q * scale`` (q int8 (..., K*CHUNK), scale (..., K))
    rounded to float32, in place in ``acc``: the fused multiply-add that
    XLA makes of the reference's dequantize-and-add.  The product of an
    int8 code and a float32 scale (31 bits) is exact in float64, and so is
    its sum with a float32 within 2**21 of it in magnitude, which is then
    rounded once, as the fused multiply-add rounds it (farther apart,
    float64's rounding could in rare cases make a tie that one rounding
    would not).  The same on every device.  Runs in slices of
    ``_FMA_SLICE`` elements to bound the float64 temporaries."""
    a = acc.reshape(-1)
    qf = q.reshape(-1, CHUNK)
    sf = scale.reshape(-1, 1)
    rows = _FMA_SLICE // CHUNK
    for r in range(0, qf.shape[0], rows):
        prod = qf[r:r + rows].double() * sf[r:r + rows].double()
        part = a[r * CHUNK:(r + rows) * CHUNK]
        part.copy_(part.double().add_(prod.reshape(-1), alpha=sign))
    return acc


def _pad_to(x: torch.Tensor, mult: int) -> torch.Tensor:
    pad = (-x.shape[0]) % mult
    return torch.nn.functional.pad(x, (0, pad)) if pad else x


def int8_psum(x: torch.Tensor, group, err: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback int8 all-reduce of a flat float32 vector over
    ``group``.  Returns (the sum (x's shape, float32), the new residual);
    ``err`` is this rank's residual of earlier rounds (x's shape)."""
    n_dev = torch.distributed.get_world_size(group)
    n = x.shape[0]
    flat = _pad_to(x + err, n_dev * CHUNK)
    shard = flat.shape[0] // n_dev

    # 1-2) quantize and exchange: int8 on the wire
    q, s = _quantize(flat.reshape(n_dev, shard))
    q_x = collectives.all_to_all(q, group)
    s_x = collectives.all_to_all(s, group)

    # 3-4) this rank's shard summed in float32 in rank order, requantized
    local = torch.zeros(shard, dtype=torch.float32, device=x.device)
    for j in range(n_dev):
        _add_product(local, q_x[j], s_x[j])
    del q_x, s_x
    q2, s2 = _quantize(local[None])
    del local

    # 5) all-gather the int8 shards
    qg = collectives.all_gather(q2[0], group)
    sg = collectives.all_gather(s2[0], group)
    del q2, s2
    out = _dequantize(qg, sg).reshape(-1)[:n]
    del qg, sg

    # 6) error feedback: what quantization lost of this rank's share
    new_err = _add_product(flat, q, s, sign=-1.0)[:n]
    return out, new_err


def tree_size(tree) -> int:
    return sum(leaf.numel() for _, leaf in tree_paths(tree))


def flatten_tree(tree) -> Tuple[torch.Tensor, Any]:
    """Every leaf as float32, concatenated in the order ``jax.tree_util``
    flattens the same dict (sorted keys); returns (flat, aux)."""
    leaves = [leaf for _, leaf in tree_paths(tree)]
    flat = torch.cat([leaf.reshape(-1).float() for leaf in leaves])
    skeleton = map_tree(lambda _: None, tree)
    return flat, (skeleton, [(leaf.shape, leaf.dtype) for leaf in leaves])


def unflatten_tree(flat: torch.Tensor, aux) -> Any:
    like, shapes = aux
    out, off = [], 0
    for shp, dt in shapes:
        n = shp.numel()
        out.append(flat[off:off + n].reshape(shp).to(dt))
        off += n
    return tree_unflatten(like, out)


def compressed_grad_psum(grads, group, err_flat: torch.Tensor):
    """int8-all-reduce a whole gradient tree (flattened once); returns
    (the summed tree, the new flat residual)."""
    flat, aux = flatten_tree(grads)
    reduced, new_err = int8_psum(flat, group, err_flat)
    return unflatten_tree(reduced, aux), new_err
