from pigs_tpu_torch.utils.sampling import (boundary_band_samples,
                                           collocation_samples, grid_samples,
                                           image_samples, region_kernel)

__all__ = ["grid_samples", "image_samples", "region_kernel",
           "collocation_samples", "boundary_band_samples"]
