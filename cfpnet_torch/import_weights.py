"""Import PyTorch weights into the port's parameter names.

    python -m cfpnet_torch.import_weights --src ckpt.pt --dst weights.pt \\
        [--kind reference|timm] [@configs/X.txt ...]

Port of ``tools/import_torch_weights.py::main``. Everything not listed above
(flags or @argfiles) is forwarded to the config parser, so the import is
checked against the topology the model is trained or evaluated with.

- ``--kind reference``: a reference-trained ``Deltar`` checkpoint
  (``module.`` prefixes and a ``"model"`` wrapper allowed; the reference's
  dead parameters dropped) -> the port's full state_dict
  (``weights.reference_state_dict``); missing and unused keys against
  ``weights.name_map`` of the config (the tiny backbone's under
  ``--tiny_model``).
- ``--kind timm``: a timm ``tf_efficientnetv2_b3`` state_dict -> the
  backbone's ``img_encoder.*`` keys (``weights.timm_backbone_state_dict``);
  load it with ``load_state_dict(..., strict=False)``.

``--dst`` is written with ``torch.save``: a flat state_dict that
``weights.load_reference_checkpoint`` (and so ``--weight_path`` of the
entry points, for a full import) reads. The JAX tool writes an orbax
checkpoint instead; the missing/unused messages on stderr are the same.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

import torch

from . import weights
from .config import parse_config
from .models.efficientnetv2 import V2_B3_STAGES, V2_TINY_STAGES


def main(argv: Optional[List[str]] = None) -> str:
    """Writes ``--dst``; returns its path."""
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--src", required=True, help="torch checkpoint (.pt)")
    ap.add_argument("--dst", required=True, help="output state_dict (.pt)")
    ap.add_argument("--kind", choices=["timm", "reference"], default="reference")
    args, config_args = ap.parse_known_args(sys.argv[1:] if argv is None else argv)
    config = parse_config(config_args)

    sd = torch.load(args.src, map_location="cpu", weights_only=True)
    if "model" in sd and hasattr(sd["model"], "items"):
        sd = sd["model"]
    if args.kind == "timm":
        out, missing, unused = weights.timm_backbone_state_dict(sd)
    else:
        stages = V2_TINY_STAGES if config.tiny_model else V2_B3_STAGES
        out, missing, unused = weights.reference_state_dict(sd, config, stages)

    if missing:
        print(f"WARNING: {len(missing)} expected keys missing, e.g. {missing[:5]}",
              file=sys.stderr)
    if unused:
        print(f"note: {len(unused)} source keys unused, e.g. {unused[:5]}", file=sys.stderr)
    torch.save(out, args.dst)
    print(f"imported {args.kind} checkpoint -> {args.dst}")
    return args.dst


if __name__ == "__main__":
    main()
