"""Plain torch versions of the Mamba-2 SSD chunk scan: the CPU path of the
kernel's wrapper and what the CUDA kernel is held against on the card.

``ssd_chunked`` is the port of the reference model's chunked scan
(src/repro/models/mamba2.py), the Mamba-2 layer's plain path in the
compute dtype.  ``ssd_scan_ref`` is the function of the TPU kernel's body
``_ssd_kernel`` (src/repro/kernels/ssd_scan/kernel.py): ``ssd_chunked``
with x, B and C in float32.  ``ssd_ref_sequential`` is the port of the
reference's exact step-by-step recurrence
(src/repro/kernels/ssd_scan/ref.py), the tests' ground truth.
``ssd_split_ref`` mirrors the CUDA kernel's three passes (each chunk's
cumsum and own state, the states passed from chunk to chunk, each chunk's
output) in float32; the tests hold it to the others, and nothing on the
main path calls it.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def _chunk_body(state: torch.Tensor, xq: torch.Tensor, dtq: torch.Tensor,
                Aq: torch.Tensor, Bq: torch.Tensor, Cq: torch.Tensor,
                causal: torch.Tensor):
    """One chunk of ``ssd_chunked``: (the state after it, its output)."""
    dtype = xq.dtype
    cum = torch.cumsum(Aq, dim=1)                          # (B,Q,H)
    # intra-chunk (dual, attention-like form); the (Q,Q,H) tiles in the
    # compute dtype, as in the reference
    L = cum[:, :, None, :] - cum[:, None, :, :]            # (B,Q,Q,H)
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
    last = cum[:, -1:, :]                                  # (B,1,H)
    decay = torch.exp(last - cum)                          # (B,Q,H)
    Sc = torch.einsum("bqhn,bqhp->bhpn",
                      (Bq.float() * (decay * dtq)[..., None]).to(dtype), xq)
    state = (torch.exp(last[:, 0, :])[:, :, None, None] * state
             + Sc.float())
    return state, y_intra + y_inter


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

    def reshape_c(t):
        return t.reshape(b, nc, chunk, *t.shape[2:])

    xc, dtc = reshape_c(xh), reshape_c(dt)
    Bc, Cc = reshape_c(Bh), reshape_c(Ch)
    Adt = dtc * A                                          # (B,nc,Q,H) <= 0
    iq = torch.arange(chunk, device=xh.device)
    causal = (iq[:, None] >= iq[None, :])[None, :, :, None]
    state = torch.zeros(b, h, p, n, dtype=torch.float32, device=xh.device)
    body = _chunk_body
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xh, dt, A, Bh, Ch)):
        # the reference remats the chunk body: the backward pass
        # recomputes each chunk's (Q, Q, H) tiles instead of keeping them
        body = functools.partial(checkpoint, _chunk_body,
                                 use_reentrant=False)
    ys = []
    for c in range(nc):
        state, y = body(state, xc[:, c], dtc[:, c], Adt[:, c], Bc[:, c],
                        Cc[:, c], causal)
        ys.append(y)
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


def ssd_split_ref(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  Bh: torch.Tensor, Ch: torch.Tensor,
                  chunk: int = 256) -> torch.Tensor:
    """The CUDA kernel's decomposition in plain torch, float32 throughout:
    (a) each chunk's cumsum of dt * A and its own state
    x^T (B o e^{cum_last - cum} dt); (b) the states passed over the chunks
    in order, h_in(0) = 0, h_in(c+1) = e^{cum_last(c)} h_in(c) + own(c);
    (c) each chunk's y = (C B^T o L o dt_j) x + (C o e^cum) h_in^T.  Chunks
    of ``min(chunk, S)`` positions, a ragged S padded with dt = 0; returns
    y: (B, S, H, P) in xh's dtype."""
    b, s0, h, p = xh.shape
    q = min(chunk, s0)
    nc = -(-s0 // q)
    pad = nc * q - s0

    def chunks(t):
        t = F.pad(t.float(), (0, 0) * (t.dim() - 2) + (0, pad))
        return t.reshape(b, nc, q, *t.shape[2:])
    x, dtc, Bc, Cc = chunks(xh), chunks(dt), chunks(Bh), chunks(Ch)
    # (a) the cumsum (B, nc, Q, H) and each chunk's own state (B, nc, H, P, N)
    cum = torch.cumsum(dtc * A, dim=2)
    last = cum[:, :, -1]                                   # (B, nc, H)
    dec = torch.exp(last[:, :, None] - cum) * dtc
    own = torch.einsum("bcqhp,bcqhn->bchpn", x, Bc * dec[..., None])
    # (b) the state entering each chunk
    state = torch.zeros_like(own[:, 0])
    h_in = []
    for c in range(nc):
        h_in.append(state)
        state = torch.exp(last[:, c])[..., None, None] * state + own[:, c]
    h_in = torch.stack(h_in, dim=1)                        # (B, nc, H, P, N)
    # (c) each chunk's output
    causal = torch.ones(q, q, dtype=torch.bool, device=xh.device).tril()
    L = torch.exp(cum.transpose(2, 3)[..., :, None]
                  - cum.transpose(2, 3)[..., None, :])     # (B, nc, H, i, j)
    M = (torch.einsum("bcihn,bcjhn->bchij", Cc, Bc)
         * torch.where(causal, L, 0.0) * dtc.transpose(2, 3)[..., None, :])
    y = (torch.einsum("bchij,bcjhp->bcihp", M, x)
         + torch.einsum("bcihn,bchpn->bcihp", Cc * torch.exp(cum)[..., None],
                        h_in))
    return y.reshape(b, nc * q, h, p)[:, :s0].to(xh.dtype)
