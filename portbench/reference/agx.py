"""The display transform (post_processing.comp:47-190): AgX's input
matrix, log2 encoding between -12.47393 and 4.026069 EV, the sixth-order
sigmoid fit, the default look, the inverse outset matrix and the 2.2
power, a floor of 1e-6, NaN shown red, clamped to [0, 1]."""

from __future__ import annotations

import torch

_IN = ((0.842479062253094, 0.0784335999999992, 0.0792237451477643),
       (0.0423282422610123, 0.878468636469772, 0.0791661274605434),
       (0.0423756549057051, 0.0784336, 0.879142973793104))
_OUT = ((1.19687900512017, -0.0980208811401368, -0.0990297440797205),
        (-0.0528968517574562, 1.15190312990417, -0.0989611768448433),
        (-0.0529716355144438, -0.0980434501171241, 1.15107367264116))
_LO, _HI = -12.47393, 4.026069


def _apply(m, x):
    return (torch.tensor(m, dtype=x.dtype, device=x.device)
            * x[..., None, :]).sum(-1)


def tonemap(col: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    x = _apply(_IN, col.to(dtype))
    x = torch.clamp(torch.log2(torch.clamp_min(x, 1e-10)), _LO, _HI)
    x = (x - _LO) / (_HI - _LO)
    x2 = x * x
    x4 = x2 * x2
    x = (15.5 * x4 * x2 - 40.14 * x4 * x + 31.96 * x4
         - 6.868 * x2 * x + 0.4298 * x2 + 0.1191 * x - 0.00232)
    x = torch.pow(torch.clamp_min(_apply(_OUT, x), 0.0), 2.2)
    x = torch.clamp_min(x, 0.000001)
    red = torch.tensor([1.0, 0.0, 0.0], dtype=x.dtype, device=x.device)
    x = torch.where(torch.isnan(x).any(-1, keepdim=True), red, x)
    return torch.clamp(x, 0.0, 1.0).float()
