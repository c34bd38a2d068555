"""A full-field digital mammogram as a detector stores it for
presentation, drawn from the generator it is given: the breast a
half-ellipse against the chest wall (the left edge) whose compressed
thickness rolls off smoothly toward the skin line, fibroglandular texture
as low-frequency structure over most of the 16-bit range, Gaussian quantum
noise (its sigma `quantum_gain` times the root of the signal), and outside
the breast a flat low background with the detector's noise
(`detector_sigma`, everywhere)."""

import torch
import torch.nn.functional as F

BACKGROUND = 1500.0
FAT = 18000.0      # the signal of fatty tissue at full thickness
DENSE = 58000.0    # of dense fibroglandular tissue
SKIN = 0.12        # the roll-off's width, as a share of the radius


def _field(height, width, cell, gen, device):
    """A smooth random field of unit scale: normal draws on a grid of
    `cell` pixels, upsampled bicubically."""
    gh, gw = -(-height // cell) + 3, -(-width // cell) + 3
    g = torch.randn((1, 1, gh, gw), generator=gen, device=device,
                    dtype=torch.float32).to(torch.float64)
    up = F.interpolate(g, size=(gh * cell, gw * cell), mode="bicubic",
                       align_corners=False)
    return up[0, 0, cell:cell + height, cell:cell + width]


def make(height, width, components, gen, device, quantum_gain,
         detector_sigma):
    if components != 1:
        raise ValueError("breast_phantom makes one-component images")
    f64 = torch.float64
    u = torch.rand(4, generator=gen, device=device, dtype=f64)
    cy = height * (0.48 + 0.04 * u[0])
    ry = height * (0.40 + 0.04 * u[1])
    rx = width * (0.70 + 0.08 * u[2])
    y = torch.arange(height, device=device, dtype=f64)[:, None]
    x = torch.arange(width, device=device, dtype=f64)[None, :]
    r = torch.sqrt(((y - cy) / ry) ** 2 + (x / rx) ** 2)
    t = ((1.0 - r) / SKIN).clamp(0.0, 1.0)
    thick = t * t * (3.0 - 2.0 * t)
    side = max(height, width)
    tex = _field(height, width, max(side // 16, 4), gen, device) + \
        0.5 * _field(height, width, max(side // 64, 2), gen, device)
    density = torch.sigmoid(1.5 * tex + 2.0 * (0.5 - r) + 0.4 * u[3])
    signal = BACKGROUND + thick * (FAT + (DENSE - FAT) * density)
    noise = torch.randn((2, height, width), generator=gen, device=device,
                        dtype=torch.float32).to(f64)
    quantum = quantum_gain * torch.sqrt(signal - BACKGROUND) * noise[0]
    img = signal + quantum + detector_sigma * noise[1]
    return img[:, :, None]
