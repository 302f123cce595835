from repro_torch.training.trainer import (
    ByzantineConfig, TrainerConfig, TrainState, build_train_step, init_state,
    kappa_hat_masked, merge_params, split_params, train_loop,
)

__all__ = ["ByzantineConfig", "TrainerConfig", "TrainState",
           "build_train_step", "init_state", "kappa_hat_masked",
           "merge_params", "split_params", "train_loop"]
