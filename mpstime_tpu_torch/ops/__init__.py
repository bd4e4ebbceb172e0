from .decomp import split_bond_left, split_bond_right
from .env import (boundary_env, build_left_envs, build_right_envs,
                  env_step_left, env_step_right)
from .bond_update import apply_update, bond_yhat, kld_loss_grad, mse_loss_grad
from .bond_kernels import bond_block_steps, bond_step

__all__ = ["split_bond_left", "split_bond_right", "boundary_env",
           "build_left_envs", "build_right_envs", "env_step_left",
           "env_step_right", "apply_update", "bond_yhat", "kld_loss_grad",
           "mse_loss_grad", "bond_step", "bond_block_steps"]
