"""Weights in and out of the port (`intrepppid_tpu/utils/torch_convert.py`
counterpart).

Three layouts meet here:

* the JAX package's params tree (nested dicts of arrays, per-direction LSTM
  weights) — ``from_jax_params`` maps it, as numpy arrays, onto the port's
  ``state_dict``, so both packages can compute with identical weights;
* the reference's PyTorch Lightning ``.ckpt`` key layout, which
  ``python -m intrepppid_tpu export torch_ckpt`` writes and published
  INTREPPPID weights use:

      encoder.embedder.weight
      encoder.encoder.rnn.weight_ih_l{K}[_reverse]
      encoder.encoder.rnn.weight_hh_l0_raw          (weight-dropped)
      encoder.encoder.rnn.weight_hh_l{K}[_reverse]  (all others)
      encoder.encoder.rnn.bias_{ih,hh}_l{K}[_reverse]
      encoder.encoder.fc.{weight,bias}
      encoder.projection.model.{0,2,4}.{weight,bias}   (dead Projection)
      head.classify.fc1.module.{weight_raw,bias}
      head.classify.fc2.module.{weight_raw,bias}
      triplet_projection.1.{weight,bias}               (when use_projection)

* the port's own ``state_dict`` (``models/awd_lstm.py`` names);
  ``to_jax_params`` maps it back to the params tree, from which
  ``save_reference_checkpoint`` writes a reference ``.ckpt`` (``python -m
  intrepppid_tpu_torch export torch_ckpt``).

``load_reference_checkpoint`` also takes a checkpoint directory: one of
the port's own ``Trainer.fit`` (a ``state.pt`` inside) or one of the JAX
package's (an orbax tree, read without JAX by ``train/orbax_read.py``);
``train/checkpoint.py:checkpoint_kind`` tells them apart and refuses
anything else. ``from_jax_state`` turns a JAX training state (weights,
optimizer state, step, epoch, SWA average) into the port's.
"""
from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

Params = Dict[str, Any]
_DIRS = (("fwd", ""), ("bwd", "_reverse"))


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.asarray(t, np.float32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def from_jax_params(params: Params) -> Dict[str, torch.Tensor]:
    """The JAX package's params tree (numpy leaves) -> the port's
    ``state_dict`` (f32 CPU tensors; ``load_state_dict`` moves them)."""
    enc = params["encoder"]
    sd = {"encoder.embedding": _t(enc["embedding"])}
    for l, lp in enumerate(enc["lstm"]):
        for name in ("w_ih", "w_hh", "b_ih", "b_hh"):
            sd[f"encoder.lstm.{l}.{name}"] = torch.stack(
                [_t(lp["fwd"][name]), _t(lp["bwd"][name])]
            )
    sd["encoder.fc.weight"] = _t(enc["fc"]["w"])
    sd["encoder.fc.bias"] = _t(enc["fc"]["b"])
    for i, p in enumerate(enc.get("projection", [])):
        sd[f"encoder.projection.{i}.weight"] = _t(p["w"])
        sd[f"encoder.projection.{i}.bias"] = _t(p["b"])
    for fc in ("fc1", "fc2"):
        sd[f"head.{fc}.weight"] = _t(params["head"][fc]["w"])
        sd[f"head.{fc}.bias"] = _t(params["head"][fc]["b"])
    if "triplet_projection" in params:
        sd["triplet_projection.weight"] = _t(params["triplet_projection"]["w"])
        sd["triplet_projection.bias"] = _t(params["triplet_projection"]["b"])
    return sd


def to_jax_params(sd: Dict[str, torch.Tensor]) -> Params:
    """Inverse of :func:`from_jax_params`: the port's ``state_dict`` -> a
    params tree in the JAX package's layout (f32 numpy leaves). A network
    built without ``use_projection`` has no ``triplet_projection``, and
    neither has the tree."""
    n_layers = len({k.split(".")[2] for k in sd if k.startswith("encoder.lstm.")})
    n_proj = len([k for k in sd if k.startswith("encoder.projection.")
                  and k.endswith(".weight")])
    encoder: Params = {
        "embedding": _np(sd["encoder.embedding"]),
        "lstm": [
            {d: {name: _np(sd[f"encoder.lstm.{l}.{name}"][i])
                 for name in ("w_ih", "w_hh", "b_ih", "b_hh")}
             for i, d in enumerate(("fwd", "bwd"))}
            for l in range(n_layers)
        ],
        "fc": {"w": _np(sd["encoder.fc.weight"]), "b": _np(sd["encoder.fc.bias"])},
    }
    if n_proj:
        encoder["projection"] = [
            {"w": _np(sd[f"encoder.projection.{i}.weight"]),
             "b": _np(sd[f"encoder.projection.{i}.bias"])}
            for i in range(n_proj)
        ]
    params: Params = {
        "encoder": encoder,
        "head": {fc: {"w": _np(sd[f"head.{fc}.weight"]), "b": _np(sd[f"head.{fc}.bias"])}
                 for fc in ("fc1", "fc2")},
    }
    if "triplet_projection.weight" in sd:
        params["triplet_projection"] = {"w": _np(sd["triplet_projection.weight"]),
                                        "b": _np(sd["triplet_projection.bias"])}
    return params


def reference_to_params(sd: Dict[str, Any], rnn_num_layers: int = 2) -> Params:
    """A reference ``state_dict`` -> a params tree in the JAX package's
    layout (numpy leaves)."""
    lstm = []
    for layer in range(rnn_num_layers):
        lp = {}
        for direction, suffix in _DIRS:
            hh = f"encoder.encoder.rnn.weight_hh_l{layer}{suffix}"
            if hh + "_raw" in sd:  # the weight-dropped matrix
                hh += "_raw"
            lp[direction] = {
                "w_ih": _np(sd[f"encoder.encoder.rnn.weight_ih_l{layer}{suffix}"]),
                "w_hh": _np(sd[hh]),
                "b_ih": _np(sd[f"encoder.encoder.rnn.bias_ih_l{layer}{suffix}"]),
                "b_hh": _np(sd[f"encoder.encoder.rnn.bias_hh_l{layer}{suffix}"]),
            }
        lstm.append(lp)
    encoder: Params = {
        "embedding": _np(sd["encoder.embedder.weight"]),
        "lstm": lstm,
        "fc": {"w": _np(sd["encoder.encoder.fc.weight"]),
               "b": _np(sd["encoder.encoder.fc.bias"])},
    }
    if "encoder.projection.model.0.weight" in sd:
        encoder["projection"] = [
            {"w": _np(sd[f"encoder.projection.model.{i}.weight"]),
             "b": _np(sd[f"encoder.projection.model.{i}.bias"])}
            for i in (0, 2, 4)
        ]
    params: Params = {
        "encoder": encoder,
        "head": {
            fc: {"w": _np(sd[f"head.classify.{fc}.module.weight_raw"]),
                 "b": _np(sd[f"head.classify.{fc}.module.bias"])}
            for fc in ("fc1", "fc2")
        },
    }
    if "triplet_projection.1.weight" in sd:
        params["triplet_projection"] = {
            "w": _np(sd["triplet_projection.1.weight"]),
            "b": _np(sd["triplet_projection.1.bias"]),
        }
    return params


def params_to_reference(params: Params) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`reference_to_params`. Like the JAX exporter it
    emits the LSTM under both of the reference's registration paths
    (``rnn`` and ``rnn_dp.module``), so the reference can load it strictly."""
    enc = params["encoder"]
    sd = {"encoder.embedder.weight": _t(enc["embedding"])}
    for layer, lp in enumerate(enc["lstm"]):
        for direction, suffix in _DIRS:
            hh = f"weight_hh_l{layer}{suffix}"
            if layer == 0 and direction == "fwd":
                hh += "_raw"
            dp = lp[direction]
            for name, arr in ((f"weight_ih_l{layer}{suffix}", dp["w_ih"]),
                              (hh, dp["w_hh"]),
                              (f"bias_ih_l{layer}{suffix}", dp["b_ih"]),
                              (f"bias_hh_l{layer}{suffix}", dp["b_hh"])):
                sd[f"encoder.encoder.rnn.{name}"] = _t(arr)
                sd[f"encoder.encoder.rnn_dp.module.{name}"] = _t(arr)
    sd["encoder.encoder.fc.weight"] = _t(enc["fc"]["w"])
    sd["encoder.encoder.fc.bias"] = _t(enc["fc"]["b"])
    if "projection" not in enc:
        raise ValueError(
            "params have no dead-Projection weights (include_dead_projection=False), "
            "but the reference module tree requires encoder.projection.* for a "
            "strict load_state_dict")
    for i, idx in enumerate((0, 2, 4)):
        sd[f"encoder.projection.model.{idx}.weight"] = _t(enc["projection"][i]["w"])
        sd[f"encoder.projection.model.{idx}.bias"] = _t(enc["projection"][i]["b"])
    for fc in ("fc1", "fc2"):
        sd[f"head.classify.{fc}.module.weight_raw"] = _t(params["head"][fc]["w"])
        sd[f"head.classify.{fc}.module.bias"] = _t(params["head"][fc]["b"])
    if "triplet_projection" in params:
        sd["triplet_projection.1.weight"] = _t(params["triplet_projection"]["w"])
        sd["triplet_projection.1.bias"] = _t(params["triplet_projection"]["b"])
    return sd


def save_reference_checkpoint(params: Params, path,
                              hyper_parameters: Optional[Dict[str, Any]] = None,
                              epoch: Optional[int] = None,
                              global_step: Optional[int] = None) -> int:
    """Write ``params`` (JAX layout) as a reference-layout ``.ckpt``, as the
    JAX package's ``save_torch_checkpoint`` does: f32 CPU tensors under
    ``state_dict``, and ``hyper_parameters``, ``epoch`` and ``global_step``
    where given. Returns the number of ``state_dict`` entries."""
    sd = params_to_reference(params)
    chkpt: Dict[str, Any] = {"state_dict": sd}
    if hyper_parameters is not None:
        chkpt["hyper_parameters"] = dict(hyper_parameters)
    if epoch is not None:
        chkpt["epoch"] = int(epoch)
    if global_step is not None:
        chkpt["global_step"] = int(global_step)
    torch.save(chkpt, path)
    return len(sd)


def _jax_leaves(tree) -> list:
    """A tree's leaves in JAX's flatten order: dict keys sorted, lists in
    order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _jax_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _jax_leaves(v)]
    return [tree]


def _jax_unflatten(tree, leaves):
    """``tree``'s structure with the next of ``leaves`` (an iterator) at
    each leaf, in JAX's flatten order."""
    if isinstance(tree, dict):
        return {k: _jax_unflatten(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_jax_unflatten(v, leaves) for v in tree]
    return next(leaves)


# the JAX optimizer state's params-shaped trees, after its count, and the
# port's per-parameter buffer each becomes (optim/ranger21.py; optax's
# ScaleByAdamState -> torch.optim.AdamW)
RANGER21_BUFFERS = (("grad_ma", "grad_ma"), ("neg_grad_ma", "neg_grad_ma"),
                    ("variance_ma", "variance_ma"), ("slow_params", "slow"))
ADAM_BUFFERS = (("mu", "exp_avg"), ("nu", "exp_avg_sq"))


def _opt_state(leaves: list, params: Params, net, optimizer) -> Dict[str, Any]:
    """The JAX optimizer state's leaf list -> ``optimizer.state_dict()`` for
    the live ``optimizer`` (of ``net.optimizer_type``) over ``net``'s
    parameters, each buffer looked up by its parameter's name."""
    optimizer_type = net.optimizer_type
    template = _jax_leaves(params)
    n = len(template)
    ranger = optimizer_type.startswith("ranger21")
    buffers = RANGER21_BUFFERS if ranger else ADAM_BUFFERS
    # Ranger21: count and four trees; optax adamw: Adam's count and two
    # trees, then a schedule's count where the rate is a schedule
    scheduled = int(optimizer_type in ("adamw_1cycle", "adamw_cosine"))
    want = 1 + len(buffers) * n + scheduled
    if len(leaves) != want:
        raise ValueError(f"the checkpoint's optimizer state holds {len(leaves)} leaves; "
                         f"{optimizer_type} over {n} parameter tensors holds {want}")
    count = np.asarray(leaves[0])
    if count.shape != () or (scheduled and int(np.asarray(leaves[-1])) != int(count)):
        raise ValueError("the optimizer's step count is not one scalar")
    trees = {}
    for k, (jax_name, port_name) in enumerate(buffers):
        part = leaves[1 + k * n:1 + (k + 1) * n]
        for leaf, like in zip(part, template):
            if np.shape(leaf) != np.shape(like):
                raise ValueError(f"optimizer leaf of shape {np.shape(leaf)} for a parameter "
                                 f"of shape {np.shape(like)} ({jax_name})")
        trees[port_name] = from_jax_params(_jax_unflatten(params, iter(part)))
    # the optimizer's state index of each parameter is its place in the
    # optimizer's groups
    name_of = {id(p): name for name, p in net.named_parameters()}
    order = [name_of[id(p)] for g in optimizer.param_groups for p in g["params"]]
    if sorted(order) != sorted(trees[buffers[0][1]]):
        raise ValueError(f"the optimizer's parameters {sorted(order)} are not the "
                         f"checkpoint's {sorted(trees[buffers[0][1]])}")
    state: Dict[int, Dict[str, torch.Tensor]] = {}
    for i, name in enumerate(order):
        state[i] = {b: trees[b][name] for _, b in buffers}
        if not ranger:
            state[i]["step"] = torch.tensor(float(count), dtype=torch.float32)
    out: Dict[str, Any] = {"state": state,
                           "param_groups": optimizer.state_dict()["param_groups"]}
    if ranger:
        out["count"] = int(count)
    return out


def from_jax_state(restored: Dict[str, Any], net=None, optimizer=None) -> Dict[str, Any]:
    """A JAX training state, as its ``CheckpointManager.restore`` (or
    ``train/orbax_read.py:restore_orbax``) returns it, in the layout
    ``train/checkpoint.py`` saves: ``params`` and ``swa_avg`` as the port's
    ``state_dict`` (``from_jax_params``), ``global_step``, ``epoch`` and
    ``swa_n`` as ints, and, given the network and its live optimizer,
    ``opt_state`` as that optimizer's ``state_dict()`` (its
    ``param_groups`` kept). The optimizer's leaf list is cut by the params
    tree's leaves in JAX's order, per ``net.optimizer_type``: Ranger21's
    count and its ``grad_ma``, ``neg_grad_ma``, ``variance_ma`` and
    ``slow_params`` trees (`intrepppid_tpu/optim/ranger21.py:142-147`), or
    optax AdamW's count, ``mu`` and ``nu`` and, under a schedule, the
    schedule's count. A leaf list that does not fit the type raises."""
    if (net is None) != (optimizer is None):
        raise TypeError("the optimizer state needs both the network and its optimizer")
    state: Dict[str, Any] = {"params": from_jax_params(restored["params"]),
                             "global_step": int(restored["global_step"]),
                             "epoch": int(restored["epoch"])}
    if "swa_avg" in restored:
        state["swa_avg"] = from_jax_params(restored["swa_avg"])
        state["swa_n"] = int(restored["swa_n"])
    if optimizer is not None:
        state["opt_state"] = _opt_state(list(restored["opt_state"]), restored["params"],
                                        net, optimizer)
    return state


def load_reference_checkpoint(path, rnn_num_layers: int = 2) -> Dict[str, torch.Tensor]:
    """Read a reference-layout ``.ckpt``, or a checkpoint directory of the
    port's ``Trainer.fit`` or of the JAX package's, into the port's
    ``state_dict`` (CPU tensors).

    Only tensors and plain containers are unpickled (``weights_only``)."""
    path = Path(path)
    if path.is_dir():
        from intrepppid_tpu_torch.train.checkpoint import load_params_from_checkpoint

        return load_params_from_checkpoint(path)
    chkpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = chkpt.get("state_dict", chkpt)
    return from_jax_params(reference_to_params(sd, rnn_num_layers))


def load_weights(net: torch.nn.Module, state_dict: Dict[str, torch.Tensor]) -> None:
    """Load ``state_dict`` into ``net`` strictly, except that a state without
    ``triplet_projection`` (a network trained with ``use_projection=False``)
    keeps the net's own: the scorers build the net with one, as the
    reference does, and the pair forward never reads it. The JAX package's
    params tree simply lacks it there."""
    missing, unexpected = net.load_state_dict(state_dict, strict=False)
    missing = [k for k in missing if not k.startswith("triplet_projection.")]
    if missing or unexpected:
        raise RuntimeError(f"the weights do not fit the network: missing {missing}, "
                           f"unexpected {unexpected}")
