"""Flax parameter trees <-> torch state dicts for the dynamics network, and
optax Adam states <-> :class:`pigs_tpu_torch.train.optim.AdamState`.

A flax tree is handed over flat: its paths joined with ``/`` as keys (for
example ``params/query_0/Dense_1/kernel``) and numpy arrays as values, the
form ``scripts/export_torch_fixture.py`` writes.  The name map:

  params/InputTransform_0/latent_net/Dense_i      input_transform.latent_net.layers.i
  params/InputTransform_0/<net>/MLP_0/Dense_i     input_transform.<net>.mlp.layers.i
  params/{input_projection,delta_net}/Dense_i     {input_projection,delta_net}.layers.i
  params/{query,key}_h/Dense_i                    {query,key}.h.layers.i
  .../kernel (in, out)                            .../weight (out, in), transposed
  .../bias                                        .../bias
  params/{transform,distance_transform}_h         the same name, raw (U[0, 2))

optax's ``ScaleByAdamState`` keeps ``mu`` and ``nu`` as trees shaped like
the params, so they go through the same map (kernels transposed); its
``count`` is the step count.

The no-MLP solver's ``RawParams`` and their Adam state carry across field
by field (``no_mlp_params_from_jax``, ``no_mlp_adam_from_optax``), and so
do the fit-to-target initializer's (``fit_params_from_jax``;
``fit_adam_from_optax`` takes the four Adam states of its
``optax.multi_transform``, one per field).
"""

from __future__ import annotations

import re
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

__all__ = ["flax_to_torch_name", "torch_to_flax_name", "params_from_flax",
           "params_to_flax", "adam_from_flax", "adam_to_flax", "load_fixture",
           "load_train_fixture", "no_mlp_params_from_jax",
           "no_mlp_adam_from_optax", "no_mlp_arrays", "load_no_mlp_fixture",
           "fit_params_from_jax", "fit_adam_from_optax", "fit_adam_arrays",
           "load_fit_fixture"]

_RAW = re.compile(r"^(distance_transform|transform)_(\d+)$")


def flax_to_torch_name(path: str) -> str:
    """Map one flax path to its torch state-dict key."""
    parts = path.split("/")
    if parts[0] != "params":
        raise KeyError(f"not a flax params path: {path!r}")
    parts = parts[1:]
    if len(parts) == 1 and _RAW.match(parts[0]):
        return parts[0]
    leaf = {"kernel": "weight", "bias": "bias"}.get(parts[-1])
    if leaf is None:
        raise KeyError(f"unknown flax leaf in {path!r}")
    out = []
    for p in parts[:-1]:
        if p == "InputTransform_0":
            out.append("input_transform")
        elif p == "MLP_0":
            out.append("mlp")
        elif (m := re.fullmatch(r"Dense_(\d+)", p)):
            out += ["layers", m.group(1)]
        elif (m := re.fullmatch(r"(query|key)_(\d+)", p)):
            out += [m.group(1), m.group(2)]
        elif p in ("latent_net", "input_projection", "delta_net") or (
                p.startswith("transform_") and p.endswith("_net")):
            out.append(p)
        else:
            raise KeyError(f"unknown flax module {p!r} in {path!r}")
    return ".".join(out + [leaf])


def torch_to_flax_name(key: str) -> str:
    """Inverse of :func:`flax_to_torch_name`."""
    if _RAW.match(key):
        return f"params/{key}"
    parts = key.split(".")
    leaf = {"weight": "kernel", "bias": "bias"}[parts[-1]]
    out, i = [], 0
    body = parts[:-1]
    while i < len(body):
        p = body[i]
        if p == "input_transform":
            out.append("InputTransform_0")
        elif p == "mlp":
            out.append("MLP_0")
        elif p == "layers":
            out.append(f"Dense_{body[i + 1]}")
            i += 1
        elif p in ("query", "key"):
            out.append(f"{p}_{body[i + 1]}")
            i += 1
        else:
            out.append(p)
        i += 1
    return "/".join(["params", *out, leaf])


def params_from_flax(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """A flat flax params dict -> a torch state dict (Dense kernels
    transposed, attention params carried raw).  Dtypes are kept."""
    state = {}
    for path, value in flat.items():
        arr = np.asarray(value)
        if path.endswith("/kernel"):
            arr = arr.T
        state[flax_to_torch_name(path)] = torch.tensor(arr)
    return state


def adam_from_flax(names: Sequence[str], mu: Dict[str, np.ndarray],
                   nu: Dict[str, np.ndarray], count, device=None):
    """optax Adam moments (flat flax trees, as :func:`params_from_flax`
    takes them) and count -> an ``AdamState`` whose lists follow
    ``names``, the network's ``named_parameters()`` order."""
    from pigs_tpu_torch.train.optim import AdamState
    tmu, tnu = params_from_flax(mu), params_from_flax(nu)
    return AdamState(
        mu=[tmu[k].to(device) for k in names],
        nu=[tnu[k].to(device) for k in names],
        count=torch.tensor(int(np.asarray(count)), dtype=torch.int32,
                           device=device))


def adam_to_flax(names: Sequence[str], state
                 ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray], int]:
    """Inverse of :func:`adam_from_flax`: ``(mu, nu, count)``."""
    return (params_to_flax(dict(zip(names, state.mu))),
            params_to_flax(dict(zip(names, state.nu))), int(state.count))


def _subtree(data: dict, prefix: str) -> Dict[str, np.ndarray]:
    """Pop the arrays stored under ``prefix/`` as a flat flax params tree
    (``params/...`` keys)."""
    keys = [k for k in data if k.startswith(prefix + "/")]
    return {"params/" + k[len(prefix) + 1:]: data.pop(k) for k in keys}


def _fixture_config(data: dict, dtype=torch.float32):
    """The model config a fixture names: problem, nx, capacity and, where
    the fixture names them (the NS fixtures), the split criteria; the
    period follows from the problem."""
    from pigs_tpu_torch.models.model import ModelConfig
    from pigs_tpu_torch.pde import IntegrationRule, Problem
    nx = int(data["config_nx"])
    criteria = data.get("config_split_criteria")
    return ModelConfig.create(Problem[str(data["config_problem"])],
                              IntegrationRule.TRAPEZOID, nx=nx, ny=nx, d=2,
                              scale=1.0, capacity=int(data["config_capacity"]),
                              dtype=dtype,
                              split_criteria=("value" if criteria is None
                                              else str(criteria)))


def load_train_fixture(path: str, device=None, dtype=torch.float32):
    """Load an exported training fixture
    (``scripts/export_torch_fixture.py --kind train`` or ``--kind
    ns-train``).

    Returns ``(cfg, network, opt_state, ema, data)``: the model config in
    ``dtype`` (with the fixture's split criteria where it names them), the
    network with the checkpoint's raw parameters, its Adam state, the EMA
    parameters (a list in ``network.parameters()`` order), all on
    ``device``, and the file's remaining arrays as numpy (the epoch's inputs
    under ``input_*``, the JAX references under ``step_*`` and ``epoch_*``,
    ``train_*`` the training recipe).
    """
    from pigs_tpu_torch.models.model import make_network

    with np.load(path) as z:
        data = {k: z[k] for k in z.files}
    raw = {k: data.pop(k) for k in list(data) if k.startswith("params/")}
    ema, mu, nu = (_subtree(data, p) for p in ("ema", "adam_mu", "adam_nu"))
    cfg = _fixture_config(data, dtype)
    network = make_network(cfg, frequencies=torch.from_numpy(
        data["frequencies"]), device=device)
    network.load_state_dict({k: v.to(dtype) for k, v in
                             params_from_flax(raw).items()})
    names = [k for k, _ in network.named_parameters()]
    opt = adam_from_flax(names, mu, nu, data.pop("adam_count"), device)
    opt = opt._replace(mu=[x.to(dtype) for x in opt.mu],
                       nu=[x.to(dtype) for x in opt.nu])
    tema = params_from_flax(ema)
    return (cfg, network, opt, [tema[k].to(device=device, dtype=dtype)
                                for k in names], data)


def checkpoint_train_fixture(path: str, checkpoint_dir: str, device=None,
                             expect=None):
    """Write an exported training fixture (:func:`load_train_fixture`) as
    the port's checkpoint at the fixture's epoch in ``checkpoint_dir``
    (parameters, Adam state, EMA; no training loss), unless the directory
    holds one at that epoch or later, so that ``train(resume=True)``
    resumes there.  With ``expect`` (a model config), a fixture of another
    problem, grid or capacity raises ValueError and writes nothing.
    Returns the fixture's model config."""
    from pigs_tpu_torch.train.checkpoint import latest_epoch, save_checkpoint
    cfg, net, opt, ema, data = load_train_fixture(path, device=device)
    if expect is not None:
        got, want = ((c.problem.name, c.nx, c.ny, c.capacity)
                     for c in (cfg, expect))
        if got != want:
            raise ValueError(f"{path} holds (problem, nx, ny, capacity) "
                             f"{got}, not {want}")
    epoch = int(data["train_epoch"])
    if (latest_epoch(checkpoint_dir) or -1) < epoch:
        names = [k for k, _ in net.named_parameters()]
        save_checkpoint(checkpoint_dir, epoch, dict(net.named_parameters()),
                        opt, [], ema=dict(zip(names, ema)))
    return cfg


def load_fixture(path: str, device=None):
    """Load an exported rollout fixture (``scripts/export_torch_fixture.py``).

    Returns ``(cfg, network, data)``: the model config (with the fixture's
    split criteria where it names them, as the NS fixture does), the
    dynamics network with the fixture's parameters and frequencies in
    float32 on ``device``, and the file's remaining arrays (``jax_frames``,
    ``fd_frames``, ...) as numpy.
    """
    from pigs_tpu_torch.models.model import make_network

    with np.load(path) as z:
        data = {k: z[k] for k in z.files}
    flat = {k: data.pop(k) for k in list(data) if k.startswith("params/")}
    cfg = _fixture_config(data)
    network = make_network(cfg, frequencies=torch.from_numpy(
        data["frequencies"]), device=device)
    network.load_state_dict(params_from_flax(flat))
    return cfg, network, data


NO_MLP_FIELDS = ("raw_means", "values", "raw_scaling", "transforms")


def no_mlp_params_from_jax(params: Sequence, device=None, dtype=None):
    """The JAX package's no-MLP ``RawParams`` (or its four arrays in field
    order, as numpy) -> the port's ``RawParams`` on ``device``, in ``dtype``
    (default: the arrays' own)."""
    from pigs_tpu_torch.train.no_mlp import RawParams
    return RawParams(*(torch.tensor(np.asarray(x), dtype=dtype, device=device)
                       for x in params))


def no_mlp_adam_from_optax(mu: Sequence, nu: Sequence, count, device=None,
                           dtype=None):
    """optax's ``ScaleByAdamState`` of a no-MLP solve (``mu`` and ``nu``
    RawParams of arrays, ``count``) -> an ``AdamState`` whose lists follow
    the RawParams fields, so a solve resumes from a JAX state."""
    from pigs_tpu_torch.train.optim import AdamState
    return AdamState(
        mu=list(no_mlp_params_from_jax(mu, device, dtype)),
        nu=list(no_mlp_params_from_jax(nu, device, dtype)),
        count=torch.tensor(int(np.asarray(count)), dtype=torch.int32,
                           device=device))


def no_mlp_arrays(data: dict, prefix: str) -> list:
    """The four RawParams arrays a fixture stores under ``prefix/<field>``
    (``scripts/export_torch_fixture.py --kind no-mlp``)."""
    return [data[f"{prefix}/{f}"] for f in NO_MLP_FIELDS]


def load_no_mlp_fixture(path: str, dtype=torch.float32):
    """Load the no-MLP fixture: ``(cfg, densify_every, data)``, the
    ``NoMLPConfig`` of its recipe in ``dtype``, its densify cadence and its
    arrays as numpy (see :func:`no_mlp_arrays`)."""
    from pigs_tpu_torch.pde import Problem
    from pigs_tpu_torch.train.no_mlp import NoMLPConfig
    with np.load(path) as z:
        data = {k: z[k] for k in z.files}
    cfg = NoMLPConfig(
        problem=Problem[str(data["config_problem"])], dtype=dtype,
        **{f: data[f"config_{f}"].item() for f in (
            "d", "scale", "n_init", "capacity", "n_samples", "dt", "nu", "lr",
            "block_iters", "max_iters", "tol", "init_raw_scaling",
            "warm_up_blocks", "min_keep", "active_sampling",
            "sampling_inflate", "lr_min")})
    return cfg, int(data["config_densify_every"]), data


def fit_params_from_jax(params: Sequence, device=None, dtype=None):
    """The JAX fit's ``RawParams`` (or its four arrays in field order) ->
    the port's, on ``device`` in ``dtype``; the fit shares the no-MLP
    solver's RawParams."""
    return no_mlp_params_from_jax(params, device, dtype)


FIT_GROUPS = ("means", "values", "scaling", "transforms")


def fit_adam_from_optax(groups: Sequence, device=None, dtype=None):
    """The fit's ``optax.multi_transform`` state, given as its four
    ``ScaleByAdamState``s in RawParams field order, each ``(mu, nu,
    count)`` of that group's one field as numpy -> a
    :class:`pigs_tpu_torch.train.fit.FitOptState` (each group keeps its
    count)."""
    from pigs_tpu_torch.train.fit import FitOptState
    from pigs_tpu_torch.train.optim import AdamState
    return FitOptState(*(
        AdamState(mu=[torch.tensor(np.asarray(mu), dtype=dtype,
                                   device=device)],
                  nu=[torch.tensor(np.asarray(nu), dtype=dtype,
                                   device=device)],
                  count=torch.tensor(int(np.asarray(count)),
                                     dtype=torch.int32, device=device))
        for mu, nu, count in groups))


def fit_adam_arrays(data: dict, prefix: str) -> list:
    """The four ``(mu, nu, count)`` a fit fixture stores under
    ``prefix/<group>_{mu,nu,count}``, in RawParams field order."""
    return [tuple(data[f"{prefix}/{g}_{k}"] for k in ("mu", "nu", "count"))
            for g in FIT_GROUPS]


def load_fit_fixture(path: str, dtype=torch.float32):
    """Load the fit fixture: ``(cfg, split_cfg, data)``, the curl fit's
    ``FitConfig`` and the split state's, both in ``dtype``, and the arrays
    as numpy (see ``scripts/export_torch_fixture.py --kind fit``; its
    RawParams under ``prefix/<field>``, read with :func:`no_mlp_arrays`)."""
    from pigs_tpu_torch.train.fit import FitConfig
    with np.load(path) as z:
        data = {k: z[k] for k in z.files}

    def config(prefix):
        return FitConfig(dtype=dtype, **{
            f: data[f"{prefix}_{f}"].item() for f in (
                "d", "nx", "capacity", "n_samples", "block_iters", "iters",
                "split_every_blocks", "tanh_means", "curl", "periodic")})
    return config("config"), config("split_config"), data


def params_to_flax(state: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Inverse of :func:`params_from_flax`."""
    flat = {}
    for key, value in state.items():
        arr = value.detach().cpu().numpy()
        if key.endswith(".weight"):
            arr = arr.T
        flat[torch_to_flax_name(key)] = np.ascontiguousarray(arr)
    return flat
