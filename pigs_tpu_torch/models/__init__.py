from pigs_tpu_torch.models.dynamics import Deltas, DynamicsNetwork
from pigs_tpu_torch.models.model import (Losses, LossWeights, ModelConfig,
                                         StepFields, adaptive_split,
                                         compute_loss, forward_step,
                                         make_initial_state, make_network,
                                         randomize_state,
                                         randomize_state_dynamic,
                                         sample_fields)
from pigs_tpu_torch.models.state import MixtureState, covariance_of, init_state

__all__ = ["MixtureState", "init_state", "covariance_of", "DynamicsNetwork",
           "Deltas", "LossWeights", "ModelConfig", "make_initial_state",
           "forward_step", "make_network", "StepFields", "Losses",
           "sample_fields", "compute_loss", "adaptive_split",
           "randomize_state", "randomize_state_dynamic"]
