from diffusion_pruning_tpu_torch.pipelines.pruning_pipeline import PruningPipeline

__all__ = ["PruningPipeline"]
