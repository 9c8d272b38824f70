from pigs_tpu_torch.utils.sampling import grid_samples, image_samples

__all__ = ["grid_samples", "image_samples"]
