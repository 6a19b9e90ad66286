"""Carry state between the JAX package and the port.

The JAX package's state reaches this module as numpy arrays (for
example ``jax.tree.map(np.asarray, carry)``); this module never imports
JAX. ``*_to_torch`` turns it into the port's tensors on a chosen
device, ``*_to_numpy`` turns the port's tensors back, so both packages
can compute from the same state.

dtypes stay as they are (float32, int32, bool), with one exception: a
JAX PRNG key is ``uint32[2]`` (``jax.random.key_data`` of a typed key,
or a raw ``PRNGKey``), and the port keeps key words in int64 (see
``core.prand``). NamedTuples are matched by field name, so a JAX
``BanditState`` converts to the port's ``BanditState``.

``model_params_to_torch`` carries a model's weights: the JAX package's
``init_params`` pytree (as numpy, layers stacked on a leading L axis)
into the port's ``Model``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.continuum.metrics import MetricAccumulator
from repro_torch.continuum.scenarios import Drivers
from repro_torch.core.bandit import BanditState
from repro_torch.device import resolve_device
from repro_torch.models.model_zoo import Model, build_model

# The step carry's 9 slots, as the reference's ``build_sim_parts`` lays
# them out; the last three are None on the ported path.
CARRY_SLOTS = ("state", "queue", "prev_active", "acc", "groups", "pids",
               "breaker", "control", "recorder")


def array_to_torch(x, device=None) -> torch.Tensor:
    """One numpy array (float32/int32/bool) as a tensor on ``device``."""
    a = np.asarray(x)
    if a.dtype not in (np.float32, np.int32, np.bool_):
        raise TypeError(f"unexpected dtype {a.dtype}: the port's state is "
                        "float32, int32 or bool")
    return torch.from_numpy(np.array(a, copy=True)).to(resolve_device(device))


def array_to_numpy(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def key_to_torch(key_data, device=None) -> torch.Tensor:
    """``uint32[..., 2]`` key words -> int64 tensor on ``device``."""
    a = np.asarray(key_data)
    if a.dtype != np.uint32 or a.shape[-1] != 2:
        raise TypeError(f"a JAX key is uint32[..., 2]; got {a.dtype} "
                        f"{a.shape}")
    return torch.from_numpy(a.astype(np.int64)).to(resolve_device(device))


def key_to_numpy(key: torch.Tensor) -> np.ndarray:
    return key.detach().cpu().numpy().astype(np.uint32)


def _tuple_to_torch(cls, x, device):
    return cls(**{f: array_to_torch(getattr(x, f), device)
                  for f in cls._fields})


def _tuple_to_numpy(x):
    return type(x)(*(array_to_numpy(v) for v in x))


def bandit_state_to_torch(s, device=None) -> BanditState:
    return _tuple_to_torch(BanditState, s, device)


def accumulator_to_torch(acc, device=None) -> MetricAccumulator:
    return _tuple_to_torch(MetricAccumulator, acc, device)


def drivers_to_torch(drv, device=None) -> Drivers:
    return _tuple_to_torch(Drivers, drv, device)


def carry_to_torch(carry, device=None) -> tuple:
    """The 9-slot step carry ``(state, queue, prev_active, acc, groups,
    pids, breaker, control, recorder)``; the last three must be None
    (resilience, control and the recorder are not ported)."""
    if len(carry) != len(CARRY_SLOTS):
        raise ValueError(f"a step carry has {len(CARRY_SLOTS)} slots")
    state, q, prev_active, acc, groups, pids, *rest = carry
    if any(r is not None for r in rest):
        raise NotImplementedError("breaker/control/recorder carry slots are "
                                  "not ported (ROADMAP A9)")
    return (bandit_state_to_torch(state, device), array_to_torch(q, device),
            array_to_torch(prev_active, device),
            None if acc is None else accumulator_to_torch(acc, device),
            array_to_torch(groups, device), array_to_torch(pids, device),
            None, None, None)


def carry_to_numpy(carry) -> tuple:
    """The port's step carry as numpy arrays, in the same 9 slots."""
    state, q, prev_active, acc, groups, pids, *rest = carry
    return (_tuple_to_numpy(state), array_to_numpy(q),
            array_to_numpy(prev_active),
            None if acc is None else _tuple_to_numpy(acc),
            array_to_numpy(groups), array_to_numpy(pids), *rest)


def _flatten(tree, prefix: str = ""):
    for name, sub in tree.items():
        key = f"{prefix}{name}"
        if isinstance(sub, dict):
            yield from _flatten(sub, key + ".")
        else:
            yield key, np.asarray(sub)


def model_params_to_torch(params, cfg: ModelConfig, device=None) -> Model:
    """The reference's ``init_params(key, cfg)`` pytree (numpy leaves:
    ``embed.tok``/``embed.unembed``, ``final_norm``, ``layers.*`` with
    a leading L axis: ``ln1``, ``attn.*``, ``ln2``, ``mlp.*`` for a
    dense stack, ``ln1`` and ``ssm.{in_proj, conv_w, conv_b, A_log,
    dt_bias, norm, out_proj}`` for an SSM stack) as the port's ``Model``
    on ``device``. Matrices and the conv weights are cast once to
    ``cfg.dtype`` (the reference casts at every use, with the same
    rounding); norm weights, ``A_log`` and ``dt_bias`` stay float32. A
    missing, extra or misshapen leaf raises (``load_state_dict``,
    strict)."""
    model = build_model(cfg, device=device)
    state = {}
    for key, arr in _flatten(params):
        if key.startswith("layers."):
            rest = key[len("layers."):]
            for i in range(arr.shape[0]):
                state[f"params.layers.{i}.{rest}"] = torch.from_numpy(
                    np.array(arr[i], copy=True))
        else:
            state[f"params.{key}"] = torch.from_numpy(np.array(arr, copy=True))
    model.load_state_dict(state, strict=True)
    return model
