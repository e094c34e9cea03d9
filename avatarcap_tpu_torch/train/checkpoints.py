"""Checkpoints of a training state (counterpart of
avatarcap_tpu/train/checkpoints.py), in the reference's layout: one
directory per checkpoint (``epoch_N/``, ``epoch_latest/``) holding the
network and the optimizer. Here both are torch files: ``net.pt``, the
model's state_dict under the reference's key names (so a reference
network loads the same way, weights.load_reference_state_dict), and
``optm.pt``, each Adam group's state and the step count.
"""

from __future__ import annotations

import os

import torch

from avatarcap_tpu_torch.weights import load_reference_checkpoint

NET_FILE = "net.pt"
OPTM_FILE = "optm.pt"


def save_train_state(dir_path: str, state) -> None:
    os.makedirs(dir_path, exist_ok=True)
    torch.save(state.model.state_dict(), os.path.join(dir_path, NET_FILE))
    torch.save({"opt_state": {k: opt.state_dict()
                              for k, opt in state.opt.items()},
                "step": int(state.step)},
               os.path.join(dir_path, OPTM_FILE))


def load_network(dir_path: str, model: torch.nn.Module) -> None:
    """Load a checkpoint's network into ``model`` (strict; a released
    reference checkpoint loads too)."""
    load_reference_checkpoint(model, os.path.join(dir_path, NET_FILE))


def load_train_state(dir_path: str, state):
    """Load what save_train_state wrote into ``state``'s model and
    optimizer (in place, on their device); returns the state with the
    checkpoint's step count."""
    load_network(dir_path, state.model)
    optm = torch.load(os.path.join(dir_path, OPTM_FILE), map_location="cpu",
                      weights_only=True)
    if set(optm["opt_state"]) != set(state.opt):
        raise ValueError(f"checkpoint has optimizer groups "
                         f"{sorted(optm['opt_state'])}, the state "
                         f"{sorted(state.opt)}")
    for k, opt in state.opt.items():
        opt.load_state_dict(optm["opt_state"][k])
    return state._replace(step=int(optm["step"]))
