"""Hugging Face Hub upload at the end of training.

The port's copy of the JAX package's `utils/hub.py`: when the config sets
`training.hf_hub.push_to_hub`, the run directory is uploaded to a Hub repo
(`hub_model_id`, else the run directory's name) once training ends,
without the rotation and step artifacts (`DEFAULT_IGNORE`). The prune and
finetune entry points call `maybe_push_to_hub(cfg, run_dir)` last, on rank
0 after the loop's final barrier. `huggingface_hub` is imported where it is
used: without it, an opted-in config raises a RuntimeError and any other
config never needs it.
"""
from __future__ import annotations

import logging
import os
from typing import Optional, Sequence

logger = logging.getLogger(__name__)

# rotation and step artifacts left out of the upload
DEFAULT_IGNORE = ("step_*", "epoch_*", "checkpoint-*/state/*")


def _hub_api():
    try:
        import huggingface_hub
    except ImportError as e:
        raise RuntimeError("training.hf_hub.push_to_hub=true requires the huggingface_hub "
                           "package (not installed on this machine)") from e
    return huggingface_hub


def create_training_repo(run_dir: str, hub_model_id: Optional[str] = None,
                         token: Optional[str] = None) -> str:
    """Create (or reuse) the Hub repo of a training run; returns its repo_id
    (`hub_model_id`, else the run directory's name, as the Hub names it)."""
    hub = _hub_api()
    repo_id = hub_model_id or os.path.basename(os.path.normpath(run_dir))
    repo = hub.create_repo(repo_id=repo_id, exist_ok=True, token=token)
    return getattr(repo, "repo_id", repo_id)


def push_run_to_hub(run_dir: str, repo_id: str, token: Optional[str] = None,
                    commit_message: str = "End of training",
                    ignore_patterns: Sequence[str] = DEFAULT_IGNORE) -> None:
    """Upload the run directory to `repo_id`."""
    hub = _hub_api()
    hub.upload_folder(repo_id=repo_id, folder_path=run_dir, commit_message=commit_message,
                      ignore_patterns=list(ignore_patterns), token=token)
    logger.info("pushed %s to hub repo %s", run_dir, repo_id)


def maybe_push_to_hub(config, run_dir: str) -> Optional[str]:
    """The end-of-training hook: honour `training.hf_hub.*`. Returns the
    repo_id after an upload, None when the config does not opt in. Raises
    only when it opted in and the upload cannot happen."""
    hf = config.get_path("training.hf_hub", None) if hasattr(config, "get_path") else None
    if not hf or not hf.get("push_to_hub", False):
        return None
    token = hf.get("hub_token")
    repo_id = create_training_repo(run_dir, hf.get("hub_model_id"), token)
    push_run_to_hub(run_dir, repo_id, token)
    return repo_id
