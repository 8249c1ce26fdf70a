"""A float64 reference of the covariance-method AR normal equations, built
another way than the port's (index gather of the lag matrix, chunked over
rows, in float64 on the input's device), for the port's tests on the CPU
and on the card and for chip_smoke.py. torch only."""

import torch


def ar_normal_equations_f64(x: torch.Tensor, length: torch.Tensor, order: int, chunk: int = 16384):
    """(gram (C, p, p), moment (C, p)) in float64 of x (C, N): rows
    n = p..min(length, N)-1, A[r, k-1] = x[n-k], y = -x[n]."""
    c, n = x.shape
    p = int(order)
    xd = x.to(torch.float64)
    lags = torch.arange(1, p + 1, device=x.device)
    gram = torch.zeros((c, p, p), dtype=torch.float64, device=x.device)
    moment = torch.zeros((c, p), dtype=torch.float64, device=x.device)
    for i in range(c):
        stop = min(int(length[i]), n)
        for row0 in range(p, stop, chunk):
            rows = torch.arange(row0, min(row0 + chunk, stop), device=x.device)
            a = xd[i][rows[:, None] - lags[None, :]]
            gram[i] += a.T @ a
            moment[i] -= a.T @ xd[i][rows]
    return gram, moment


def relative_frobenius(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max over the leading (channel) axis of ||got - ref||_F / ||ref||_F."""
    err = torch.linalg.matrix_norm((got.to(torch.float64) - ref).reshape(ref.shape[0], -1, ref.shape[-1]))
    return float((err / torch.linalg.matrix_norm(ref.reshape(ref.shape[0], -1, ref.shape[-1]))).max())
