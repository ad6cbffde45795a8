"""Image quality metrics: PSNR and SSIM (port of ``repro/core/metrics.py``;
standard 11x11 Gaussian window)."""
from __future__ import annotations

import torch


def psnr(img: torch.Tensor, ref: torch.Tensor, *,
         max_val: float = 1.0) -> torch.Tensor:
    mse = torch.mean((img - ref) ** 2)
    return 10.0 * torch.log10(max_val * max_val / torch.clamp_min(mse, 1e-12))


def _gaussian_window(size: int = 11, sigma: float = 1.5, *,
                     device=None) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) \
        - (size - 1) / 2.0
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    return g / g.sum()


def _filter2d(img: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """Separable valid-mode filtering of (H, W) with a 1D window."""
    k = win.shape[0]
    out = (img.unfold(0, k, 1) * win.flip(0)).sum(-1)
    return (out.unfold(1, k, 1) * win.flip(0)).sum(-1)


def ssim(img: torch.Tensor, ref: torch.Tensor, *,
         max_val: float = 1.0) -> torch.Tensor:
    """Mean SSIM over an (H, W, 3) image pair (Wang et al. 2004 constants)."""
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    win = _gaussian_window(device=img.device)
    vals = []
    for ch in range(img.shape[-1]):
        x, y = img[..., ch], ref[..., ch]
        mu_x = _filter2d(x, win)
        mu_y = _filter2d(y, win)
        mu_xx, mu_yy, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
        sig_xx = _filter2d(x * x, win) - mu_xx
        sig_yy = _filter2d(y * y, win) - mu_yy
        sig_xy = _filter2d(x * y, win) - mu_xy
        num = (2 * mu_xy + c1) * (2 * sig_xy + c2)
        den = (mu_xx + mu_yy + c1) * (sig_xx + sig_yy + c2)
        vals.append(torch.mean(num / den))
    return torch.stack(vals).mean()
