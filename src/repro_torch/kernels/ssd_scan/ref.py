"""Plain torch versions of the Mamba-2 SSD chunk scan: the CPU path of the
kernel's wrapper and what the CUDA kernel is held against on the card.

``ssd_chunked`` is the port of the reference model's chunked scan
(src/repro/models/mamba2.py), the Mamba-2 layer's plain path in the
compute dtype.  ``ssd_scan_ref`` is the function of the TPU kernel's body
``_ssd_kernel`` (src/repro/kernels/ssd_scan/kernel.py): ``ssd_chunked``
with x, B and C in float32.  ``ssd_ref_sequential`` is the port of the
reference's exact step-by-step recurrence
(src/repro/kernels/ssd_scan/ref.py), the tests' ground truth.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bh: torch.Tensor, Ch: torch.Tensor, chunk: int):
    """Chunked SSD scan (the plain baseline, in the compute dtype).

    xh: (B, S, H, P); dt: (B, S, H) float32 (post-softplus); A: (H,)
    float32 (negative); Bh, Ch: (B, S, H, N).  Returns y: (B, S, H, P) and
    the final state (B, H, P, N) float32.
    """
    b, s0, h, p = xh.shape
    n = Bh.shape[-1]
    # pad S to a chunk multiple with dt = 0 (identity state transition: the
    # padded steps neither decay the state nor inject input)
    s = -(-s0 // chunk) * chunk
    if s != s0:
        pad = (0, 0, 0, 0, 0, s - s0)
        xh, Bh, Ch = F.pad(xh, pad), F.pad(Bh, pad), F.pad(Ch, pad)
        dt = F.pad(dt, (0, 0, 0, s - s0))
    nc = s // chunk
    dtype = xh.dtype

    def reshape_c(t):
        return t.reshape(b, nc, chunk, *t.shape[2:])

    xc, dtc = reshape_c(xh), reshape_c(dt)
    Bc, Cc = reshape_c(Bh), reshape_c(Ch)
    Adt = dtc * A                                          # (B,nc,Q,H) <= 0
    iq = torch.arange(chunk, device=xh.device)
    causal = (iq[:, None] >= iq[None, :])[None, :, :, None]
    state = torch.zeros(b, h, p, n, dtype=torch.float32, device=xh.device)
    ys = []
    for c in range(nc):
        xq, dtq, Aq, Bq, Cq = xc[:, c], dtc[:, c], Adt[:, c], Bc[:, c], \
            Cc[:, c]
        cum = torch.cumsum(Aq, dim=1)                      # (B,Q,H)
        # intra-chunk (dual, attention-like form); the (Q,Q,H) tiles in the
        # compute dtype, as in the reference
        L = cum[:, :, None, :] - cum[:, None, :, :]        # (B,Q,Q,H)
        L = torch.where(causal, torch.exp(L), 0.0).to(dtype)
        CB = torch.einsum("bihn,bjhn->bijh", Cq, Bq)
        M = CB * L * dtq[:, None, :, :].to(dtype)
        y_intra = torch.einsum("bijh,bjhp->bihp", M, xq)
        # inter-chunk: the carried state's contribution
        y_inter = torch.einsum(
            "bqhn,bhpn->bqhp",
            (Cq.float() * torch.exp(cum)[..., None]).to(dtype),
            state.to(dtype))
        # the chunk's new state
        last = cum[:, -1:, :]                              # (B,1,H)
        decay = torch.exp(last - cum)                      # (B,Q,H)
        Sc = torch.einsum("bqhn,bqhp->bhpn",
                          (Bq.float() * (decay * dtq)[..., None]).to(dtype),
                          xq)
        state = (torch.exp(last[:, 0, :])[:, :, None, None] * state
                 + Sc.float())
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(b, s, h, p)
    return y[:, :s0], state



def ssd_scan_ref(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bh: torch.Tensor, Ch: torch.Tensor,
                 chunk: int = 256) -> torch.Tensor:
    """xh: (B, S, H, P); dt: (B, S, H) float32 (post-softplus); A: (H,)
    float32 < 0; Bh, Ch: (B, S, H, N) -> y: (B, S, H, P) in xh's dtype.

    ``ssd_chunked`` on x, B and C cast to float32, so every product is
    float32, with chunks of ``min(chunk, S)`` positions; the output is cast
    once to xh's dtype.
    """
    y, _ = ssd_chunked(xh.float(), dt, A, Bh.float(), Ch.float(),
                       min(chunk, xh.shape[1]))
    return y.to(xh.dtype)


def ssd_ref_sequential(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                       Bh: torch.Tensor, Ch: torch.Tensor) -> torch.Tensor:
    """The exact step-by-step recurrence (the ground truth):
    h_t = exp(A dt_t) h_{t-1} + dt_t B_t x_t^T, y_t = C_t . h_t, in
    float32; returns (B, S, H, P) in xh's dtype."""
    b, s, h, p = xh.shape
    x, Bf, Cf = xh.float(), Bh.float(), Ch.float()
    state = torch.zeros(b, h, p, Bh.shape[-1], dtype=torch.float32,
                        device=xh.device)
    ys = []
    for t in range(s):
        decay = torch.exp(dt[:, t] * A)                           # (B,H)
        state = (state * decay[..., None, None]
                 + torch.einsum("bhn,bhp->bhpn", Bf[:, t] * dt[:, t, :, None],
                                x[:, t]))
        ys.append(torch.einsum("bhn,bhpn->bhp", Cf[:, t], state))
    return torch.stack(ys, dim=1).to(xh.dtype)
