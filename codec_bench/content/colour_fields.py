"""chip_smoke.py `make_config2`'s content on the card (BASELINE config 2's
photo): smooth colour fields, red a product of a sine across and a cosine
down, green a sine across, blue a cosine down, plus Gaussian noise."""

import torch


def make(height, width, components, gen, device, noise_sigma):
    if components != 3:
        raise ValueError("colour_fields makes RGB images")
    f64 = torch.float64
    x = torch.arange(width, device=device, dtype=f64)
    y = torch.arange(height, device=device, dtype=f64)
    # the angle steps as multiples of the reciprocal, as the limits in
    # cells/ were read on
    red = 128 + (90 * torch.sin(x * (1 / 23)))[None, :] * \
        torch.cos(y * (1 / 17))[:, None]
    green = (128 + 80 * torch.sin(x * (1 / 15)))[None, :].expand(height, -1)
    blue = (128 + 80 * torch.cos(y * (1 / 19)))[:, None].expand(-1, width)
    field = torch.stack([red, green, blue], dim=-1)
    noise = torch.randn(field.shape, generator=gen, device=device,
                        dtype=torch.float32)
    return field + noise_sigma * noise.to(f64)
