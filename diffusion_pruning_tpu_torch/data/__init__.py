from diffusion_pruning_tpu_torch.data.datasets import (
    get_dataset,
    load_cc3m_dataset,
    load_coco_dataset,
)
from diffusion_pruning_tpu_torch.data.loader import DataPipeline, filter_dataset

__all__ = [
    "DataPipeline",
    "filter_dataset",
    "get_dataset",
    "load_cc3m_dataset",
    "load_coco_dataset",
]
