"""The 1-D no-MLP Burgers IC fit against the JAX package's band (CPU).

artifacts/no_mlp_1d_torch.npz (scripts/export_torch_fixture.py --kind
no-mlp-1d) holds JAX's IC fit at scripts/solve_no_mlp.py's defaults for
seeds 0-9: the rel-L2 against exp(-2 x^2) on 201 points where
``solve_timestep`` stops, and the same fits followed block by block for 50
blocks, with seed 0's first five blocks of draws.

* The port's IC fit on those draws tracks JAX's block by block: the
  rel-L2 after each of the five blocks within 5% of JAX's (float32 on
  both sides, summed in other orders).
* The band itself: with a constant learning rate of 1e-2, Adam keeps
  wandering once the fit reaches a loss near 1e-7, and JAX's own rel-L2
  after blocks 10-50 reaches 0.0175-0.0407 for every seed, while where
  ``solve_timestep`` stops it reads 0.0006-0.004.  So a single fit's error
  is a draw from that range: the card's 0.0145 (chip_smoke.py phase 12d,
  CUDA seed 0) lies inside it.
"""

import pathlib

import numpy as np
import torch

from pigs_tpu_torch.ops.mixture import eval_mixture
from pigs_tpu_torch.pde import Problem
from pigs_tpu_torch.train import no_mlp as nm
from pigs_tpu_torch.train.optim import adam_init

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "artifacts" / "no_mlp_1d_torch.npz"
TRACK_REL = 0.05
CARD_IC_REL_L2 = 0.0145   # phase 12d's IC fit on the card (CUDA seed 0)


def rel_l2(cfg, params, active, points):
    x = (torch.linspace(-1, 1, points) * cfg.scale).reshape(-1, 1)
    with torch.no_grad():
        u = eval_mixture(*nm.concrete(cfg, params), x, order=0,
                         mask=active).u[:, 0]
    target = torch.exp(-2.0 * x[:, 0] ** 2)
    return float(torch.linalg.norm(u - target) / torch.linalg.norm(target))


def test_ic_fit_tracks_jax_on_its_draws():
    cfg = nm.NoMLPConfig(problem=Problem.BURGERS, d=1)
    with np.load(FIXTURE) as z:
        base, time = z["draws_base"], z["draws_time"]
        want = z["block_rel_l2"][0, :base.shape[0]]
        points = int(z["config_points"])
    params, active = nm.init_params(cfg)
    params = nm.RawParams(*(p.requires_grad_() for p in params))
    opt = adam_init(params)
    got = []
    for b in range(base.shape[0]):
        draws = nm.BlockDraws(torch.from_numpy(base[b]), None, None,
                              torch.from_numpy(time[b]))
        params, opt, _, _ = nm._run_block(cfg, params, opt, active, None,
                                          True, draws, b * cfg.block_iters)
        got.append(rel_l2(cfg, params, active, points))
    np.testing.assert_allclose(got, want, rtol=TRACK_REL)


def test_jax_band_holds_the_card_result():
    with np.load(FIXTURE) as z:
        final, blocks = z["final_rel_l2"], z["block_rel_l2"]
    assert final.shape == (10,) and blocks.shape == (10, 50)
    late = blocks[:, 10:]
    # Where solve_timestep stops, JAX's fits are good ...
    assert final.max() < 0.005
    # ... but every seed's fit wanders past the card's value later on,
    # and spends most blocks well below it.
    assert (late.max(axis=1) > CARD_IC_REL_L2).all()
    assert (np.median(late, axis=1) < 0.005).all()
