"""The benchmark's weights: made on the device from the run's seed, in a few
large calls.

A family (``families/<name>.py``) gives the state dict of its reference's
skeleton on the ``meta`` device and a rule that says, leaf by leaf, whether
the leaf is a constant (norm scales, biases, running statistics) or is drawn
normal, and with which standard deviation. ``draw`` makes every drawn leaf
from one normal draw of a device generator seeded once, in the skeleton's
order, so the same seed gives the same weights for the same skeleton.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

# what a rule gives a leaf: ("const", value) or ("normal", standard deviation)
Leaf = Tuple[str, float]


def draw(skeleton: Dict[str, torch.Tensor], rule: Callable[[str, torch.Tensor], Leaf], seed: int,
         device) -> Dict[str, torch.Tensor]:
    """The state dict of ``skeleton``'s names and shapes on ``device``, each
    leaf as ``rule(name, leaf)`` says."""
    drawn, stds = [], []
    out: Dict[str, torch.Tensor] = {}
    for name, t in skeleton.items():
        kind, value = rule(name, t)
        if kind == "const":
            out[name] = torch.full(t.shape, value, device=device)
        else:
            drawn.append(name)
            stds.append(value)
    sizes = torch.tensor([skeleton[n].numel() for n in drawn], device=device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(int(sizes.sum()), generator=gen, device=device)
    flat *= torch.repeat_interleave(torch.tensor(stds, device=device), sizes)
    for name, chunk in zip(drawn, flat.split(sizes.tolist())):
        out[name] = chunk.view(skeleton[name].shape)
    return {name: out[name] for name in skeleton}
