"""The plain PyTorch version of the RWKV-6 WKV kernel.

* :func:`wkv_ref` — the twin of ``repro/kernels/rwkv6/ref.py::wkv_ref``,
  the exact per-step recurrence that is the Pallas kernel's contract:

      y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
      S_t = diag(exp(logw_t)) S_{t-1} + k_t v_t^T,    S_0 = 0

  r/k/v/logw ``(BH, S, n)``, u ``(BH, n)``; returns y ``(BH, S, n)`` and
  the final state ``(BH, n, n)``, both float32.
* :func:`rwkv6_ref` — the same in the model's layout, r/k/v/logw
  ``(B, S, H, n)`` and u ``(H, n)``: it folds (batch, head) and tiles u,
  as the JAX wrapper (``ops.py:18-24``) does around the Pallas kernel.
  ``ops.rwkv6`` takes it for CPU tensors.
* :func:`wkv_two_level_ref` — the arithmetic of the bf16 tensor-core
  kernel (``csrc/rwkv6_mma.cu``) in plain torch ops, in the layout of
  :func:`wkv_ref`: chunks with the state carried once a chunk, 16-token
  sub-chunks and 8-token halves whose decays are taken from / to their
  ends (the reference L_p of Gated Linear Attention's secondary
  chunking, applied twice), the triangles along the diagonal pairwise as
  running products of exp(logw) <= 1, and optionally the rounding of
  every tensor-core operand.  Only the tests use it: it shows on the CPU
  that the kernel's algorithm holds the contract and never overflows,
  where a one-level split would.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def wkv_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            logw: torch.Tensor, u: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r/k/v/logw: (BH, S, n); u: (BH, n). Sequential ground truth.

    Returns (y (BH, S, n) float32, final state (BH, n, n) float32)."""
    r, k, v, logw = (t.float() for t in (r, k, v, logw))
    u = u.float()
    BH, S, n = r.shape
    state = torch.zeros((BH, n, n), dtype=torch.float32, device=r.device)
    ys = []
    for t in range(S):
        a = k[:, t, :, None] * v[:, t, None, :]            # (BH, n, n)
        ys.append(torch.einsum("bn,bnm->bm", r[:, t],
                               state + u[:, :, None] * a))
        state = state * torch.exp(logw[:, t])[:, :, None] + a
    return torch.stack(ys, 1), state


def rwkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              logw: torch.Tensor, u: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r/k/v/logw: (B, S, H, n); u: (H, n).  Returns (y (B, S, H, n)
    float32, final state (B, H, n, n) float32)."""
    B, S, H, n = r.shape
    flat = lambda t: t.transpose(1, 2).reshape(B * H, S, n)  # noqa: E731
    y, state = wkv_ref(flat(r), flat(k), flat(v), flat(logw),
                       u.repeat(B, 1))
    return y.reshape(B, H, S, n).transpose(1, 2), state.view(B, H, n, n)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32`` rounds a tensor-core operand."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _bf16_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x as hi = bf16(x) and lo = bf16(x - hi), both as float32."""
    hi = x.bfloat16().float()
    return hi, (x - hi).bfloat16().float()


def _product(a: torch.Tensor, b: torch.Tensor,
             rounding: Optional[str]) -> torch.Tensor:
    """a @ b with the operands as a tensor core takes them: float32
    (None), TF32 (``"tf32"``), or each split into two bf16 halves and
    multiplied as hi_a hi_b + hi_a lo_b + lo_a hi_b (``"bf16_split"``; a
    bf16 operand has lo = 0, so its products take two terms)."""
    if rounding is None:
        return a @ b
    if rounding == "tf32":
        return _tf32(a) @ _tf32(b)
    if rounding == "bf16_split":
        (ah, al), (bh, bl) = _bf16_split(a), _bf16_split(b)
        return ah @ bh + (ah @ bl + al @ bh)
    raise ValueError(f"rounding {rounding!r}: None, 'tf32' or 'bf16_split'")


#: the tensor-core kernel's chunk, sub-chunk and half sub-chunk, in tokens
CHUNK, SUB, HALF = 32, 16, 8


def _decays(w: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """For w = e^{logw} (..., HALF, n) in halves: the products of w before
    each token (forward), after it (backward), and over the half."""
    ones = torch.ones_like(w[..., :1, :])
    fwd = torch.cumprod(torch.cat([ones, w[..., :-1, :]], -2), -2)
    bwd = torch.flip(torch.cumprod(torch.flip(
        torch.cat([w[..., 1:, :], ones], -2), [-2]), -2), [-2])
    return fwd, bwd, fwd[..., -1, :] * w[..., -1, :]


def _triangle(r: torch.Tensor, k: torch.Tensor, w: torch.Tensor,
              u: torch.Tensor) -> torch.Tensor:
    """A half's (HALF x HALF) block of the intra-chunk matrix, r/k/w (BH,
    HALF, n): att[t, j] = sum_i r[t,i] k[j,i] prod_{j<s<t} w[s,i] for j <
    t as a running product, the bonus sum_i r[t,i] u[i] k[t,i] at j = t,
    zero above."""
    BH, T, n = r.shape
    blk = torch.zeros((BH, T, T), dtype=torch.float32, device=r.device)
    h = k.clone()                    # h[j] = k_j prod_{j<s<t} w_s
    for t in range(1, T):
        blk[:, t, :t] = torch.einsum("bi,bji->bj", r[:, t], h[:, :t])
        h[:, :t] = h[:, :t] * w[:, t, None]
    return blk + torch.diag_embed((r * u[:, None] * k).sum(-1))


def wkv_two_level_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      logw: torch.Tensor, u: torch.Tensor,
                      rounding: Optional[str] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r/k/v/logw: (BH, S, n); u: (BH, n).  The WKV recurrence in the
    tensor-core kernel's chunked form; returns (y (BH, S, n), final state
    (BH, n, n)), float32.  Any S: the last chunk is padded with r = k =
    v = 0 and logw = 0, which changes nothing.

    Per chunk of ``CHUNK`` tokens, cut into two sub-chunks of ``SUB`` and
    those into halves of ``HALF``, with w = e^{logw} <= 1 and every decay
    a product of w over a span (e^{sum of logw}, never e^{-sum}):

    * r8 = r decayed from its half's start, k8 = k decayed to its half's
      end; r_hat, k_hat the same from / to the sub-chunk's ends (the
      reference L_p of Gated Linear Attention's secondary chunking), R~ =
      r e^{Lc_prev} and K~ = k e^{total - Lc} from / to the chunk's;
    * the intra-chunk matrix: r_hat_1 k_hat_0^T (sub-chunk 1 over 0) and,
      in each sub-chunk, r8 k8^T (second half over first), each one
      product; the four triangles along the diagonal pairwise
      (:func:`_triangle`);
    * y = att v + R~ S, then S <- diag(e^{total}) S + K~^T v.

    ``rounding`` applies to every product that the kernel runs on the
    tensor cores (the off-diagonal blocks, att v, R~ S and the state
    update; see :func:`_product`): ``"bf16_split"`` as the kernel takes
    its operands, ``"tf32"`` as one-pass TF32 ``mma.sync`` would.  The
    triangles, the decays and the sums stay float32."""
    r, k, v, logw = (t.float() for t in (r, k, v, logw))
    u = u.float()
    BH, S, n = r.shape
    pad = -S % CHUNK
    if pad:
        r, k, v, logw = (torch.nn.functional.pad(t, (0, 0, 0, pad))
                         for t in (r, k, v, logw))
    state = torch.zeros((BH, n, n), dtype=torch.float32, device=r.device)
    ys = []
    for c0 in range(0, S + pad, CHUNK):
        # (BH, sub-chunk, half, token, n)
        rs, ks, vs, ls = (t[:, c0:c0 + CHUNK].reshape(BH, 2, 2, HALF, n)
                          for t in (r, k, v, logw))
        w = torch.exp(ls)
        fwd, bwd, tot = _decays(w)           # tot: (BH, 2, 2, n)
        r8, k8 = rs * fwd, ks * bwd
        sub = tot[:, :, 0] * tot[:, :, 1]    # (BH, 2, n)
        # r_hat: second halves x the first half's decay; k_hat: first
        # halves x the second's; R~, K~: the same across the sub-chunks
        r_hat = torch.stack([r8[:, :, 0], r8[:, :, 1]
                             * tot[:, :, 0, None]], 2)
        k_hat = torch.stack([k8[:, :, 0] * tot[:, :, 1, None],
                             k8[:, :, 1]], 2)
        r_til = torch.stack([r_hat[:, 0], r_hat[:, 1]
                             * sub[:, 0, None, None]], 1)
        k_til = torch.stack([k_hat[:, 0] * sub[:, 1, None, None],
                             k_hat[:, 1]], 1)
        att = torch.zeros((BH, CHUNK, CHUNK), dtype=torch.float32,
                          device=r.device)
        att[:, SUB:, :SUB] = _product(
            r_hat[:, 1].reshape(BH, SUB, n),
            k_hat[:, 0].reshape(BH, SUB, n).transpose(1, 2), rounding)
        for p in range(2):
            lo = p * SUB
            att[:, lo + HALF:lo + SUB, lo:lo + HALF] = _product(
                r8[:, p, 1], k8[:, p, 0].transpose(1, 2), rounding)
            for hf in range(2):
                at = slice(lo + hf * HALF, lo + (hf + 1) * HALF)
                att[:, at, at] = _triangle(rs[:, p, hf], ks[:, p, hf],
                                           w[:, p, hf], u)
        vc = vs.reshape(BH, CHUNK, n)
        ys.append(_product(att, vc, rounding)
                  + _product(r_til.reshape(BH, CHUNK, n), state, rounding))
        state = state * (sub[:, 0] * sub[:, 1])[:, :, None] + _product(
            k_til.reshape(BH, CHUNK, n).transpose(1, 2), vc, rounding)
    return torch.cat(ys, 1)[:, :S], state
