"""The Shepp-Logan head phantom (L. A. Shepp and B. F. Logan, "The Fourier
reconstruction of a head section", IEEE Trans. Nucl. Sci. 21(3), 1974):
its ten ellipses with their original densities, scaled to stored CT
numbers (`scale` a unit of density: air 0, brain near water's 1024, the
skull near 2000), plus Gaussian noise from the generator
(`noise_sigma`)."""

import math

import torch

# (x centre, y centre, x semi-axis, y semi-axis, angle in degrees, density)
# on [-1, 1] squared, y up: the skull, the brain, two ventricles and six
# tumours
ELLIPSES = (
    (0.0, 0.0, 0.69, 0.92, 0.0, 2.0),
    (0.0, -0.0184, 0.6624, 0.874, 0.0, -0.98),
    (0.22, 0.0, 0.11, 0.31, -18.0, -0.02),
    (-0.22, 0.0, 0.16, 0.41, 18.0, -0.02),
    (0.0, 0.35, 0.21, 0.25, 0.0, 0.01),
    (0.0, 0.1, 0.046, 0.046, 0.0, 0.01),
    (0.0, -0.1, 0.046, 0.046, 0.0, 0.01),
    (-0.08, -0.605, 0.046, 0.023, 0.0, 0.01),
    (0.0, -0.605, 0.023, 0.023, 0.0, 0.01),
    (0.06, -0.605, 0.023, 0.046, 0.0, 0.01),
)


def make(height, width, components, gen, device, scale, noise_sigma):
    if components != 1:
        raise ValueError("shepp_logan makes one-component images")
    f64 = torch.float64
    y = 1.0 - 2.0 * (torch.arange(height, device=device, dtype=f64)[:, None]
                     + 0.5) / height
    x = 2.0 * (torch.arange(width, device=device, dtype=f64)[None, :]
               + 0.5) / width - 1.0
    density = torch.zeros((height, width), device=device, dtype=f64)
    for cx, cy, a, b, deg, rho in ELLIPSES:
        c, s = math.cos(math.radians(deg)), math.sin(math.radians(deg))
        xr, yr = (x - cx) * c + (y - cy) * s, (y - cy) * c - (x - cx) * s
        density += rho * (((xr / a) ** 2 + (yr / b) ** 2) <= 1.0)
    noise = torch.randn((height, width), generator=gen, device=device,
                        dtype=torch.float32).to(f64)
    return (scale * density + noise_sigma * noise)[:, :, None]
