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
``BanditState`` converts to the port's ``BanditState``, and the
baselines' strategy states (the reference defines them inside its
strategy adapters) to the port's ``simulator.PMState`` (proxy-mity)
and ``simulator.DSState`` (Dec-SARSA, with its ``DecSarsaState``); the
breaker's ``BreakerState``, the control plane's ``ControlCarry``
(``ControlState``, ``ControlCounters``) and the flight recorder's
``RecorderState`` likewise.

``model_params_to_torch`` carries a model's weights: the JAX package's
``init_params`` pytree (as numpy, layers stacked on leading axes)
into the port's ``Model``, and ``model_params_to_numpy`` back;
``model_cache_to_torch`` carries a model's caches (prefill's or
decode's) the same way. ``adamw_state_to_torch`` and
``adamw_state_to_numpy`` carry an AdamW state (its step and the two
moment pytrees, laid out as the parameters), so both packages can take
a training step from the same parameters, moments and gradients.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.continuum.control import (ControlCarry, ControlCounters,
                                           ControlState)
from repro_torch.continuum.metrics import MetricAccumulator, each
from repro_torch.continuum.scenarios import Drivers
from repro_torch.continuum.simulator import DSState, PMState
from repro_torch.core.bandit import BanditState, BreakerState
from repro_torch.core.baselines import DecSarsaState
from repro_torch.device import resolve_device
from repro_torch.models.model_zoo import Model, build_model
from repro_torch.obs.recorder import RecorderState
from repro_torch.training.optimizer import AdamWState

# The step carry's 9 slots, as the reference's ``build_sim_parts`` lays
# them out.
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


# the NamedTuples a carry can hold, by their field names
_TUPLES = {cls._fields: cls for cls in (BanditState, PMState, DSState,
                                        DecSarsaState, BreakerState,
                                        ControlCarry, ControlState,
                                        ControlCounters, RecorderState)}


def _tuple_to_torch(cls, x, device):
    return cls(**{f: _leaf_to_torch(getattr(x, f), device)
                  for f in cls._fields})


def _leaf_to_torch(x, device):
    if isinstance(x, tuple):
        return _tuple_to_torch(_TUPLES[x._fields], x, device)
    return array_to_torch(x, device)


def _tuple_to_numpy(x):
    return type(x)(*(_tuple_to_numpy(v) if isinstance(v, tuple)
                     else array_to_numpy(v) for v in x))


def bandit_state_to_torch(s, device=None) -> BanditState:
    return _tuple_to_torch(BanditState, s, device)


def strategy_state_to_torch(s, device=None):
    """A strategy state (``BanditState``, proxy-mity's ``PMState``,
    Dec-SARSA's ``DSState``), matched by its field names."""
    fields = getattr(s, "_fields", None)
    if fields not in _TUPLES:
        raise TypeError(f"not a strategy state of the port: {type(s)}")
    return _tuple_to_torch(_TUPLES[fields], s, device)


def accumulator_to_torch(acc, device=None):
    """A ``MetricAccumulator``, or a tenant run's tuple of them."""
    return each(acc, lambda a: _tuple_to_torch(MetricAccumulator, a,
                                               device))


def drivers_to_torch(drv, device=None) -> Drivers:
    """Compiled drivers, or a ``stack_drivers`` lane batch (every field
    with a leading (S,) axis); ``key_to_torch`` takes the batch's (S, 2)
    keys the same way."""
    return _tuple_to_torch(Drivers, drv, device)


def breaker_to_torch(brk, device=None) -> BreakerState:
    return _tuple_to_torch(BreakerState, brk, device)


def control_to_torch(ctl, device=None):
    """A ``ControlCarry``, or its ``ControlCounters`` alone (the
    ``ctrl`` of a reference ``StreamOutputs``), in the reference's
    layout (one controller, no lane axis)."""
    cls = ControlCarry if ctl._fields == ControlCarry._fields \
        else ControlCounters
    return _tuple_to_torch(cls, ctl, device)


def recorder_to_torch(rec, device=None) -> RecorderState:
    """A flight recorder's ring (the reference's ``RecorderState``:
    (cap,) arrays, a (1,) ``ptr``, the breaker snapshot)."""
    return _tuple_to_torch(RecorderState, rec, device)


def recorder_to_numpy(rec: RecorderState) -> RecorderState:
    return _tuple_to_numpy(rec)


def carry_to_torch(carry, device=None) -> tuple:
    """The 9-slot step carry ``(state, queue, prev_active, acc, groups,
    pids, breaker, control, recorder)`` of any strategy, streaming
    (``acc`` set) or trace mode (``acc`` None), with or without the
    breaker, control and recorder slots. A tenant carry's state and
    accumulator slots are tuples, one member a tenant, and its queue
    is (NT, M)."""
    if len(carry) != len(CARRY_SLOTS):
        raise ValueError(f"a step carry has {len(CARRY_SLOTS)} slots")
    state, q, prev_active, acc, groups, pids, brk, ctl, rec = carry
    return (each(state, lambda s: strategy_state_to_torch(s, device)),
            array_to_torch(q, device),
            array_to_torch(prev_active, device),
            accumulator_to_torch(acc, device),
            array_to_torch(groups, device), array_to_torch(pids, device),
            None if brk is None else breaker_to_torch(brk, device),
            None if ctl is None else control_to_torch(ctl, device),
            None if rec is None else recorder_to_torch(rec, device))


def carry_to_numpy(carry) -> tuple:
    """The port's step carry as numpy arrays, in the same 9 slots."""
    state, q, prev_active, acc, groups, pids, brk, ctl, rec = carry
    return (each(state, _tuple_to_numpy), array_to_numpy(q),
            array_to_numpy(prev_active), each(acc, _tuple_to_numpy),
            array_to_numpy(groups), array_to_numpy(pids),
            each(brk, _tuple_to_numpy), each(ctl, _tuple_to_numpy),
            each(rec, _tuple_to_numpy))


def _flatten(tree, prefix: str = ""):
    for name, sub in tree.items():
        key = f"{prefix}{name}"
        if isinstance(sub, dict):
            yield from _flatten(sub, key + ".")
        else:
            yield key, np.asarray(sub)


# the stacked layer pytrees and how many leading axes stack their layers
_STACKS = {"layers": 1, "group_global": 1, "tail_local": 1, "group_local": 2,
           "enc_layers": 1, "dec_layers": 1}


def model_params_to_torch(params, cfg: ModelConfig, device=None) -> Model:
    """The reference's ``init_params(key, cfg)`` pytree (numpy leaves:
    ``embed.tok``/``embed.unembed``, ``final_norm``, and the stacked
    layers: ``layers.*`` with a leading L axis for a uniform stack, or
    ``group_local.*`` (G, nl), ``group_global.*`` (G,) and
    ``tail_local.*`` (n_tail,) for a gemma3 stack; a layer's leaves are
    ``ln1``, ``attn.*`` (with ``bq``/``bk``/``bv`` where the config has
    QKV bias), ``ssm.{in_proj, conv_w, conv_b, A_log, dt_bias, norm,
    out_proj}``, ``attn_norm``/``ssm_norm`` (hybrid), ``ln2`` with
    ``mlp.*`` or ``moe.{router, wi, wg, wo}``, by family; Whisper's
    ``embed.tok``, ``enc_layers.{ln1, attn.*, ln2, mlp.*}`` and
    ``dec_layers.{ln1, self_attn.*, ln_x, cross_attn.*, ln2, mlp.*}``
    stacked on a leading axis, ``enc_norm``, ``final_norm``) as the
    port's ``Model`` on ``device``. Matrices and the conv weights are
    cast once to ``cfg.dtype`` (the reference casts at every use, with
    the same rounding); norm weights, ``A_log``, ``dt_bias`` and the MoE
    router stay float32. A missing, extra or misshapen leaf raises
    (``load_state_dict``, strict)."""
    model = build_model(cfg, device=device)
    state = {name: torch.from_numpy(np.array(arr, copy=True))
             for name, arr in _unstacked(params).items()}
    model.load_state_dict(state, strict=True)
    return model


def _float32_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(torch.float32).cpu().numpy()


def _unstacked(tree) -> dict:
    """A reference parameter pytree (numpy leaves, layers stacked) as
    ``{port parameter name: array}``, one entry a layer."""
    out = {}
    for key, arr in _flatten(tree):
        head, _, rest = key.partition(".")
        lead = _STACKS.get(head, 0)
        for idx in np.ndindex(*arr.shape[:lead]):
            name = ".".join(("params", head, *map(str, idx), rest)
                            if lead else ("params", key))
            out[name] = arr[idx]
    return out


def named_to_numpy(named: dict) -> dict:
    """Tensors or arrays keyed by a model's parameter names (its
    parameters, their gradients, AdamW moments) as the reference's
    parameter pytree: float32 numpy leaves, each stack's layers in index
    order on its leading axes (the way back from ``_unstacked``)."""
    named = {k: _float32_numpy(x) if isinstance(x, torch.Tensor) else x
             for k, x in named.items()}
    leaves: dict = {}
    for name, arr in named.items():
        head, *rest = name.split(".")[1:]
        lead = _STACKS.get(head, 0)
        idx = tuple(int(i) for i in rest[:lead])
        leaves.setdefault((head, *rest[lead:]), {})[idx] = arr
    tree: dict = {}
    for path, by_idx in leaves.items():
        if by_idx.keys() == {()}:
            leaf = by_idx[()]
        else:
            dims = tuple(max(i[a] for i in by_idx) + 1
                         for a in range(len(next(iter(by_idx)))))
            leaf = np.stack([by_idx[i] for i in np.ndindex(*dims)])
            leaf = leaf.reshape(dims + leaf.shape[1:])
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def model_params_to_numpy(model: Model) -> dict:
    """The port's ``Model`` weights as the reference's ``init_params``
    pytree (the layout ``model_params_to_torch`` reads), float32 numpy
    leaves (bfloat16 weights widened exactly; the reference keeps its
    weights in float32)."""
    return named_to_numpy(dict(model.named_parameters()))


def adamw_state_to_torch(state, model: Model, device=None) -> AdamWState:
    """The reference's ``AdamWState`` (numpy leaves: ``step``, and ``m``
    and ``v`` laid out as the parameters) as the port's, its moments
    keyed by ``model``'s parameter names (``training.optimizer``),
    float32 on ``device``."""
    dev = resolve_device(device)

    def moments(tree):
        named = _unstacked(tree)
        return {name: torch.from_numpy(np.array(named[name], np.float32))
                .to(dev) for name, _ in model.named_parameters()}

    return AdamWState(step=torch.tensor(int(np.asarray(state.step)),
                                        dtype=torch.int32, device=dev),
                      m=moments(state.m), v=moments(state.v))


def adamw_state_to_numpy(state: AdamWState) -> AdamWState:
    """The port's ``AdamWState`` as the reference lays it out: an int32
    step and the moments as parameter pytrees of float32 numpy."""
    return AdamWState(step=np.asarray(state.step.cpu().numpy(), np.int32),
                      m=named_to_numpy(state.m), v=named_to_numpy(state.v))


def model_cache_to_torch(cache, device=None) -> dict:
    """The reference's model cache (numpy leaves, or bfloat16 arrays
    numpy holds as ``ml_dtypes``) as the port's cache dict on ``device``,
    each tensor in its reference dtype: a dict of tuples keeps its keys;
    Whisper's bare ``(k_self, v_self, k_cross, v_cross)`` goes under
    ``"layers"``."""
    if not isinstance(cache, dict):
        cache = {"layers": cache}
    dev = resolve_device(device)

    def leaf(x):
        a = np.asarray(x)
        dtype = getattr(torch, str(a.dtype))
        t = torch.from_numpy(np.array(a, dtype=np.float32, copy=True))
        return t.to(device=dev, dtype=dtype)

    return {key: tuple(leaf(x) for x in cache[key]) for key in cache}
