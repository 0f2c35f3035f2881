"""Save the captions aligned with an expert's generated images as JSON (the
CLIP-score input).

  python -m diffusion_pruning_tpu_torch.cli.save_captions \
      --base_config_path configs/img_generation/sd-2-1_coco2014.yaml \
      --pruning_ckpt_dir runs/<run> --expert_id 3 --out captions.json

The counterpart of the JAX package's `scripts/metrics/save_captions.py`:
the validation captions, or with `--pruning_ckpt_dir` and `--expert_id`
those `{dataset_name}_validation_mapped_indices.pt` assigns to the expert,
chosen by the rule `cli/generate_fid_images.py` generates from
(`expert_captions`), so the two stay aligned: the same synthetic captions
where the dataset folder is missing, and the same cap at the config's
`data.max_generated_samples`, which the JAX script does not apply. Runs on
the host.
"""
from __future__ import annotations

import argparse
import json


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Save the captions of generated images")
    p.add_argument("--base_config_path", required=True)
    p.add_argument("--pruning_ckpt_dir", default=None)
    p.add_argument("--expert_id", type=int, default=None)
    p.add_argument("--out", required=True)
    return p.parse_args(argv)


def main(argv=None) -> list:
    """Write and return the captions."""
    from diffusion_pruning_tpu_torch.cli.generate_fid_images import expert_captions
    from diffusion_pruning_tpu_torch.utils.config import load_config

    args = parse_args(argv)
    cfg = load_config(args.base_config_path)
    expert = args.expert_id if args.pruning_ckpt_dir else None
    caps = expert_captions(cfg, args.pruning_ckpt_dir, expert)
    with open(args.out, "w") as f:
        json.dump(list(caps), f)
    print(f"{len(caps)} captions → {args.out}")
    return list(caps)


if __name__ == "__main__":
    main()
