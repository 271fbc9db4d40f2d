"""Export weights as a self-contained serving artifact.

    python -m cfpnet_torch.export_serving @configs/train_cfpnet_combine1.txt \\
        --weight_path weights/<name>/best --dst artifacts/cfpnet \\
        [--serve_batch_sizes 1 8] [--serve_protocol validate] \\
        [--device cuda|cpu] [--random_init] [--tiny]

Port of ``tools/export_serving.py``. Everything not listed above (flags or
@argfiles) is forwarded to the config parser, so the same argfile that
trained the model describes the export; ``--compute_dtype bfloat16``
exports the bf16 forward. Passing ``--test_dataset`` applies the eval
driver's dataset choice (``evaluate_all.py::eval_dataset_config``: under
zjuL5 the ZJU overrides), and only then: its default is zjuL5, and a bare
export must not take the ZJU data paths. Under zjuL5 the artifact bakes in
the rig's measured zone geometry (the h5 ``fr`` rects) instead of the
config grid, and fails if the data is absent; the manifest records the
geometry, and ``evaluate_all --serving_artifact`` refuses a dataset whose
geometry does not match it.

The artifact (``serve/export.py``: programs with the weights inside,
``manifest.json``) is the complete deployable unit for its device (``--device``,
default the card); serving it needs this package's kernels and no
checkpoint.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from . import weights
from .config import parse_config
from .evaluate_all import eval_dataset_config


def main(argv: Optional[List[str]] = None) -> str:
    """Writes the artifact; returns its manifest's path."""
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--weight_path", default="",
                    help="weights file (a reference .pt or the port's own, as training "
                         "writes it); omit with --random_init")
    ap.add_argument("--random_init", action="store_true",
                    help="export the golden tests' deterministic weights "
                         "(weights.deterministic_state_dict; smoke tests). flax's random "
                         "init cannot be reproduced in PyTorch, so these are not the JAX "
                         "tool's --random_init weights")
    ap.add_argument("--dst", required=True, help="artifact output directory")
    ap.add_argument("--serve_batch_sizes", type=int, nargs="+", default=[1])
    ap.add_argument("--serve_protocol", default="validate",
                    choices=["validate", "evaluate_all"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the one device the artifact runs on")
    ap.add_argument("--tiny", action="store_true")
    args, config_args = ap.parse_known_args(sys.argv[1:] if argv is None else argv)

    config = parse_config(config_args)
    if any(a.startswith(("--test_dataset", "--test-dataset")) for a in config_args):
        config = eval_dataset_config(config)
    config = config.replace(mode="online_eval")
    tiny = args.tiny or config.tiny_model

    # a ZJUL5 deployment serves the real rig's zone-to-pixel rects, read from
    # the eval dataset as the live driver reads them; exporting the config
    # grid instead would mis-place every zone
    geoms, geometry_source = None, "config"
    if config.dataset_eval == "zjuL5":
        from .data.datasets import ZJUL5Dataset

        ds = ZJUL5Dataset(config)
        if ds.scale_geoms is None:
            raise SystemExit(f"{config.filenames_file_eval}: empty ZJUL5 sample list; "
                             "cannot derive the rig's measured zone geometry")
        geoms, geometry_source = ds.scale_geoms, "measured:zjuL5"

    if args.weight_path and not args.random_init:
        state_dict = weights.load_reference_checkpoint(args.weight_path)
    elif args.random_init:
        state_dict = weights.deterministic_state_dict(config, tiny=tiny)
    else:
        ap.error("provide --weight_path or --random_init")

    from .serve.export import export_serving_artifact

    mpath = export_serving_artifact(
        config, state_dict, args.dst,
        batch_sizes=args.serve_batch_sizes,
        protocol=args.serve_protocol,
        device=args.device,
        tiny=tiny,
        geoms=geoms,
        geometry_source=geometry_source,
    )
    print(f"serving artifact written: {mpath}")
    return mpath


if __name__ == "__main__":
    main()
