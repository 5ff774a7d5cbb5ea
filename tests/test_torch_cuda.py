"""lbm_tpu_torch's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one.  The file imports
no JAX (the machine with the card has none), so on the card it runs alone:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances, max abs error: float64 1e-13 (a few ulp of O(1) values after
the steps run; the kernel contracts multiply-adds into FMAs, the plain
version does not); float32 2e-6.
"""

import numpy as np
import pytest
import torch

from lbm_tpu_torch.kernels import bgk, channel, collide_stream, les
from lbm_tpu_torch.ops import d2q9
from lbm_tpu_torch.scenes import channel as scene

OMEGA = 1.0 / 0.8
TOL = {torch.float32: 2e-6, torch.float64: 1e-13}
SHAPES = [(torch.float64, (21, 21)), (torch.float64, (101, 101)),
          (torch.float64, (64, 130)), (torch.float64, (4, 2)),
          (torch.float32, (256, 384))]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _state(R, C, dtype, device, seed, incompressible=False, noisy=False):
    """An equilibrium at a seeded random flow; ``noisy`` multiplies each
    population by 1 + U(-0.03, 0.03), off equilibrium, where the KBC gamma
    is well defined (at equilibrium it is 0/0, regularised)."""
    rng = np.random.default_rng(seed)
    u = torch.as_tensor(rng.uniform(-0.05, 0.05, (2, R, C)), dtype=dtype, device=device)
    rho = torch.as_tensor(1.0 + rng.uniform(-0.01, 0.01, (R, C)), dtype=dtype,
                          device=device)
    eq = d2q9.incomp_equilibrium if incompressible else d2q9.equilibrium
    f = eq(u, rho)
    if noisy:
        f = f * torch.as_tensor(1.0 + rng.uniform(-0.03, 0.03, (9, R, C)),
                                dtype=dtype, device=device)
    return f.contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("substeps", [1, 3])
@pytest.mark.parametrize("dtype,shape", SHAPES)
def test_collide_stream_kernel_matches_plain(cuda, dtype, shape, substeps):
    R, C = shape
    f = _state(R, C, dtype, cuda, seed=1)
    plain = collide_stream.make_fused_step(R, C, bgk.bgk_collide_fn(OMEGA, dtype),
                                           dtype, substeps)
    before = collide_stream.COLLIDE_STREAM_BGK.launches
    got = bgk.make_fused_step(R, C, OMEGA, dtype, substeps)(f)
    torch.cuda.synchronize()
    assert collide_stream.COLLIDE_STREAM_BGK.launches - before == substeps
    assert got.is_cuda and got.dtype == dtype
    assert (got - plain(f)).abs().max().item() <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape", SHAPES)
def test_channel_kernel_matches_plain(cuda, dtype, shape):
    R, C = shape
    f = _state(R, C, dtype, cuda, seed=2, incompressible=True)
    model = channel.channel_model(1.0 / 0.9, 1.02, 1.0)
    step = channel.make_channel_fused_step(R, C, 1.0 / 0.9, 1.02, 1.0, dtype)
    before = channel.CHANNEL_BGK.launches
    got, want = f, f
    for _ in range(10):
        got = step(got)
        want = model.step(want)
    torch.cuda.synchronize()
    assert channel.CHANNEL_BGK.launches - before == 10
    assert (got - want).abs().max().item() <= TOL[dtype]


@pytest.mark.cuda
def test_horizontal_poiseuille_gate_on_the_card(cuda):
    """The reference's L2 <= 1e-11 gate in float64, every step through
    kernel 2 (test/horizontal_poiseuille_test.cpp:175)."""
    before = channel.CHANNEL_BGK.launches
    res = scene.horizontal_poiseuille(device=cuda, dtype=torch.float64)
    assert channel.CHANNEL_BGK.launches - before == res.steps
    assert res.l2 <= 1e-11, res.l2
    assert res.f.is_cuda


@pytest.mark.cuda
def test_kernels_reject_what_they_do_not_take(cuda):
    f = torch.zeros((9, 8, 16), dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        collide_stream.collide_stream_bgk(f[:, :, ::2], OMEGA)
    with pytest.raises(TypeError):
        channel.channel_bgk(f.half(), 1.0, 1.0, 1.0)
    with pytest.raises(ValueError, match="R >= 4"):
        channel.channel_bgk(f[:, :3].contiguous(), 1.0, 1.0, 1.0)
    step = bgk.make_fused_step(8, 16, OMEGA, torch.float32)
    with pytest.raises(ValueError, match="step built for"):
        step(f)


KBC_S2 = 1.0 / 0.8  # bench.py's relaxation
LES = dict(tau0=0.5 + 3e-4, cs_smag=0.17)  # bench.py's LES constants


@pytest.mark.cuda
@pytest.mark.parametrize("gamma_impl", ["factored", "direct"])
@pytest.mark.parametrize("substeps", [1, 3])
@pytest.mark.parametrize("dtype,shape", SHAPES)
def test_kbc_kernel_matches_plain(cuda, dtype, shape, substeps, gamma_impl):
    R, C = shape
    f = _state(R, C, dtype, cuda, seed=3, noisy=True)
    plain = collide_stream.make_fused_step(
        R, C, collide_stream.kbc_collide_fn(KBC_S2, gamma_impl), dtype, substeps)
    before = collide_stream.COLLIDE_STREAM_KBC.launches
    got = collide_stream.make_kbc_fused_step(R, C, KBC_S2, dtype, substeps,
                                             gamma_impl)(f)
    torch.cuda.synchronize()
    assert collide_stream.COLLIDE_STREAM_KBC.launches - before == substeps
    assert got.is_cuda and got.dtype == dtype
    assert (got - plain(f)).abs().max().item() <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape", SHAPES)
def test_channel_kbc_kernel_matches_plain(cuda, dtype, shape):
    R, C = shape
    f = _state(R, C, dtype, cuda, seed=4, noisy=True)
    args = (KBC_S2, 1.001, 1.0)
    plain = channel.kbc_channel_step(*args)
    step = channel.make_channel_fused_step(R, C, *args, dtype, family="kbc")
    before = channel.CHANNEL_KBC.launches
    got, want = f, f
    for _ in range(10):
        got = step(got)
        want = plain(want)
    torch.cuda.synchronize()
    assert channel.CHANNEL_KBC.launches - before == 10
    assert (got - want).abs().max().item() <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("substeps", [1, 3])
@pytest.mark.parametrize("dtype,shape", SHAPES)
def test_les_kernel_matches_plain(cuda, dtype, shape, substeps):
    R, C = shape
    f = _state(R, C, dtype, cuda, seed=5, noisy=True)
    plain = collide_stream.make_fused_step(
        R, C, les.les_collide_fn(dtype=dtype, **LES), dtype, substeps)
    before = les.COLLIDE_STREAM_LES.launches
    got = les.make_les_fused_step(R, C, dtype=dtype, substeps=substeps, **LES)(f)
    torch.cuda.synchronize()
    assert les.COLLIDE_STREAM_LES.launches - before == substeps
    assert (got - plain(f)).abs().max().item() <= TOL[dtype]


WRAPPERS = {
    "collide_stream_kbc": lambda f: collide_stream.collide_stream_kbc(f, KBC_S2),
    "channel_kbc": lambda f: channel.channel_kbc(f, KBC_S2, 1.001, 1.0),
    "collide_stream_les": lambda f: les.collide_stream_les(f, **LES),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_new_kernels_reject_what_they_do_not_take(cuda, name):
    launch = WRAPPERS[name]
    f = torch.zeros((9, 8, 16), dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="CUDA tensor"):
        launch(f.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        launch(f[:, :, ::2])
    with pytest.raises(TypeError):
        launch(f.to(torch.int32))
    with pytest.raises(ValueError, match=r"\(9, R, C\)"):
        launch(f[:8].contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("scene,kwargs,kernel", [
    ("ulbm_poiseuille", dict(H=24, W=24, T=400, nu=1e-2),
     lambda: channel.CHANNEL_KBC),
    ("ulbm_double_shear", dict(H=32, W=32, T=50),
     lambda: collide_stream.COLLIDE_STREAM_KBC),
    ("les_double_shear", dict(H=32, W=32, T=48, u_max=0.1, substeps=4),
     lambda: les.COLLIDE_STREAM_LES),
])
def test_ulbm_scenes_on_the_card_match_the_cpu(cuda, scene, kwargs, kernel):
    """Each ULBM scene in float64, every step through its kernel, against the
    same scene on the CPU (the plain versions): 1e-12 over the run."""
    from lbm_tpu_torch.scenes import ulbm

    before = kernel().launches
    got = getattr(ulbm, scene)(device=cuda, dtype=torch.float64, **kwargs)
    assert kernel().launches - before == kwargs["T"]  # one launch per step
    want = getattr(ulbm, scene)(device="cpu", dtype=torch.float64, **kwargs)
    assert got.steps == want.steps and got.f.is_cuda
    assert (got.f.cpu() - want.f).abs().max().item() <= 1e-12


# --- the MRT-CG kernels 6-8 -------------------------------------------------------

def _two_phase_state(R, C, dtype, device, surface_tension, seed, droplet=False):
    """A full MRT-CG state (flat planes: red, blue, + fst in CSF mode) from
    the scenes' initial densities with every population scaled by a seeded
    1 + U(-0.03, 0.03) and a seeded surface-force carry."""
    from lbm_tpu_torch.models.mrt_cg import MRTCGModel
    from lbm_tpu_torch.scenes import multiphase as mp

    red, blue = mp.DEFAULT_RED, mp.DEFAULT_BLUE
    model = MRTCGModel(red=red, blue=blue, sigma=1e-4)
    if droplet:
        r0 = mp.init_rho_droplet(R, C, red.rho_0, True, radius=R / 4)
        b0 = mp.init_rho_droplet(R, C, blue.rho_0, False, radius=R / 4)
    else:
        r0 = mp.init_rho_cosine(R, C, red.rho_0, True, -1.0)
        b0 = mp.init_rho_cosine(R, C, blue.rho_0, False, -1.0)
    st = model.init_state(r0, b0, dtype=dtype, device=device)
    rng = np.random.default_rng(seed)
    planes = [st.red.f, st.blue.f]
    planes = [p * torch.as_tensor(rng.uniform(0.97, 1.03, p.shape), dtype=dtype,
                                  device=device) for p in planes]
    if surface_tension == "csf":
        planes.append(torch.as_tensor(rng.uniform(-1e-6, 1e-6, (2, R, C)), dtype=dtype,
                                      device=device))
    return torch.cat(planes).contiguous()


MRTCG_KW = dict(sigma=1e-4, gravity=(6.25e-7, 0.0))
MRTCG_SHAPES = [(torch.float64, (21, 13), False), (torch.float64, (100, 100), True),
                (torch.float32, (21, 13), False), (torch.float32, (100, 100), True)]


@pytest.mark.cuda
@pytest.mark.parametrize("surface_tension", ["perturbation", "csf"])
@pytest.mark.parametrize("layout", ["reduced", "split", "full"])
@pytest.mark.parametrize("dtype,shape,droplet", MRTCG_SHAPES)
def test_mrtcg_kernels_match_plain(cuda, dtype, shape, droplet, layout, surface_tension):
    """Kernels 6 (reduced, 3 steps), 7 (split, 1 step) and 8 (full, 2 steps)
    against their plain versions on the same card: TOL, in both modes."""
    from lbm_tpu_torch.kernels import mrtcg
    from lbm_tpu_torch.scenes import multiphase as mp

    R, C = shape
    red, blue = mp.DEFAULT_RED, mp.DEFAULT_BLUE
    S = _two_phase_state(R, C, dtype, cuda, surface_tension, seed=R + C, droplet=droplet)
    csf = surface_tension == "csf"
    kernel, steps = {"reduced": (mrtcg.MRTCG_REDUCED, 3), "split": (mrtcg.MRTCG_SPLIT, 1),
                     "full": (mrtcg.MRTCG_FULL, 2)}[layout]
    if layout == "full":
        step = mrtcg.make_csf_fused_step if csf else mrtcg.make_mrtcg_fused_step
        step = step(R, C, red, blue, dtype=dtype, **MRTCG_KW)
        x = S if csf else S.reshape(2, 9, R, C)
    else:
        x = mrtcg.reduce_mrtcg_state(S if csf else S.reshape(2, 9, R, C),
                                     surface_tension)
        factory = (mrtcg.make_mrtcg_reduced_step if layout == "reduced"
                   else mrtcg.make_mrtcg_split_step)
        step = factory(R, C, red, blue, dtype=dtype, surface_tension=surface_tension,
                       **MRTCG_KW)
    before = kernel.launches
    got = x
    for _ in range(steps):
        got = step(got)
    torch.cuda.synchronize()
    assert kernel.launches - before == steps
    plain = mrtcg.make_plain_step(red, blue, surface_tension=surface_tension,
                                  reduced_in=layout != "full",
                                  reduced_out=layout == "reduced", **MRTCG_KW)
    want = x.reshape(-1, R, C)
    for _ in range(steps):
        want = plain(want)
    assert got.is_cuda and got.dtype == dtype
    assert (got.reshape(-1, R, C) - want).abs().max().item() <= TOL[dtype]


@pytest.mark.cuda
def test_mrtcg_substeps_launch_per_step(cuda):
    from lbm_tpu_torch.kernels import mrtcg
    from lbm_tpu_torch.scenes import multiphase as mp

    R, C = 21, 13
    S = _two_phase_state(R, C, torch.float64, cuda, "perturbation", seed=7)
    G = mrtcg.reduce_mrtcg_state(S.reshape(2, 9, R, C))
    one = mrtcg.make_mrtcg_reduced_step(R, C, mp.DEFAULT_RED, mp.DEFAULT_BLUE,
                                        dtype=torch.float64, **MRTCG_KW)
    four = mrtcg.make_mrtcg_reduced_step(R, C, mp.DEFAULT_RED, mp.DEFAULT_BLUE,
                                         dtype=torch.float64, substeps=4, **MRTCG_KW)
    before = mrtcg.MRTCG_REDUCED.launches
    got = four(G)
    torch.cuda.synchronize()
    assert mrtcg.MRTCG_REDUCED.launches - before == 4
    assert torch.equal(got, one(one(one(one(G)))))


MRTCG_WRAPPERS = {
    "reduced": (10, lambda m: m.MRTCG_REDUCED),
    "split": (10, lambda m: m.MRTCG_SPLIT),
    "full": (18, lambda m: m.MRTCG_FULL),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(MRTCG_WRAPPERS))
def test_mrtcg_kernels_reject_what_they_do_not_take(cuda, name):
    from lbm_tpu_torch.kernels import mrtcg
    from lbm_tpu_torch.scenes import multiphase as mp

    planes, kernel = MRTCG_WRAPPERS[name]
    params = mrtcg.kernel_params(mp.DEFAULT_RED, mp.DEFAULT_BLUE, 1e-4, (0.0, 0.0), 0.1,
                                 True)
    out = 10 if name == "reduced" else 18

    def launch(S, p=planes):
        return mrtcg.launch_mrtcg(kernel(mrtcg), S, params, False, p, out)

    S = torch.zeros((planes, 8, 16), dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="CUDA tensor"):
        launch(S.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        launch(S[:, :, ::2])
    with pytest.raises(TypeError):
        launch(S.to(torch.int32))
    with pytest.raises(ValueError, match=rf"\({planes}, R, C\)"):
        launch(S[:planes - 1].contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("scene,kwargs", [
    ("mrtcg_static_droplet", dict(R=25, C=25, T=20, radius=6.0)),
    ("mrtcg_rayleigh_taylor", dict(R=32, C=16, T=30)),
    ("mrt_csf_rayleigh_taylor", dict(R=32, C=16, T=20)),
])
def test_multiphase_scenes_on_the_card_match_the_cpu(cuda, scene, kwargs):
    """Each MRT-CG scene in float64 through kernels 6 (T-1 launches) and 7
    (one launch), against the same scene on the CPU: 1e-12."""
    from lbm_tpu_torch.kernels import mrtcg
    from lbm_tpu_torch.scenes import multiphase as mp

    before = (mrtcg.MRTCG_REDUCED.launches, mrtcg.MRTCG_SPLIT.launches)
    got = getattr(mp, scene)(device=cuda, dtype=torch.float64, **kwargs)
    assert mrtcg.MRTCG_REDUCED.launches - before[0] == kwargs["T"] - 1
    assert mrtcg.MRTCG_SPLIT.launches - before[1] == 1
    want = getattr(mp, scene)(device="cpu", dtype=torch.float64, **kwargs)
    for g, w in ((got.state.red.f, want.state.red.f), (got.state.blue.f, want.state.blue.f),
                 (got.state.u, want.state.u)):
        assert g.is_cuda and (g.cpu() - w).abs().max().item() <= 1e-12


# --- kernels 9-11: the channel variants, TRT and the power law --------------------

TAU_MAGIC = (3.0 / 16.0) ** 0.5 + 0.5
OM_MINUS = 1.0 / (0.5 + (3.0 / 16.0) / (1.2 - 0.5))  # TRT at tau 1.2, Lambda 3/16
VARIANTS = {
    "gravity": dict(omega=1 / TAU_MAGIC, incompressible=True, pressure=(1.0, 1.0, 0),
                    force=(-3e-4, 0.0), col_walls="bounce"),
    "specular": dict(omega=1 / TAU_MAGIC, incompressible=False,
                     pressure=(1.004, 1.0, 0), col_walls="specular"),
    "free_stream": dict(omega=1 / 0.55, incompressible=True, row_walls="abb",
                        abb_u=(0.1, 0.0), col_walls="specular"),
    "free_stream_cc": dict(omega=1 / 0.55, incompressible=False, row_walls="abb",
                           abb_u=(0.1, 0.0), col_walls="specular",
                           corner_consistent=True),
    "vertical": dict(omega=1 / TAU_MAGIC, incompressible=False,
                     pressure=(1.004, 1.0, 1), row_walls="bounce"),
    "vertical_incomp": dict(omega=1 / TAU_MAGIC, incompressible=True,
                            pressure=(1.004, 1.0, 1), row_walls="bounce"),
    "trt": dict(omega=1 / 1.2, incompressible=True, pressure=(1.004, 1.0, 0),
                col_walls="bounce", omega_minus=OM_MINUS),
}
VARIANT_SHAPES = [(torch.float64, (21, 21)), (torch.float64, (54, 42)),
                  (torch.float64, (4, 4)), (torch.float32, (256, 384))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape", VARIANT_SHAPES)
@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_channel_variant_kernel_matches_plain(cuda, name, dtype, shape):
    """Kernel 9 against its plain model step, 10 steps, from a noisy state;
    twice, so that a second writer of an entry shows as a difference."""
    kw = VARIANTS[name]
    R, C = shape
    f = _state(R, C, dtype, cuda, seed=R + C, incompressible=kw["incompressible"],
               noisy=True)
    step = channel.make_channel_variant_step(R, C, dtype=dtype, **kw)
    plain = channel.ChannelVariant(**kw).model().step
    before = channel.CHANNEL_VARIANT.launches
    runs = []
    for _ in range(2):
        got = f
        for _ in range(10):
            got = step(got)
        runs.append(got)
    want = f
    for _ in range(10):
        want = plain(want)
    torch.cuda.synchronize()
    assert channel.CHANNEL_VARIANT.launches - before == 20
    assert torch.equal(runs[0], runs[1])
    assert (runs[0] - want).abs().max().item() <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("substeps", [1, 3])
@pytest.mark.parametrize("dtype,shape", SHAPES)
def test_trt_kernel_matches_plain(cuda, dtype, shape, substeps):
    from lbm_tpu_torch.kernels import trt

    R, C = shape
    f = _state(R, C, dtype, cuda, seed=6, noisy=True)
    kw = dict(omega_plus=1 / 0.9, omega_minus=OM_MINUS)
    plain = collide_stream.make_fused_step(R, C, trt.trt_collide_fn(dtype=dtype, **kw),
                                           dtype, substeps)
    before = trt.COLLIDE_STREAM_TRT.launches
    got = trt.make_trt_fused_step(R, C, dtype=dtype, substeps=substeps, **kw)(f)
    torch.cuda.synchronize()
    assert trt.COLLIDE_STREAM_TRT.launches - before == substeps
    assert (got - plain(f)).abs().max().item() <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("n,sigma_y", [(0.5, 0.0), (1.5, 0.0), (0.8, 5e-4), (1.0, 0.0)])
@pytest.mark.parametrize("dtype,shape", [(torch.float64, (64, 130)),
                                         (torch.float64, (21, 21)),
                                         (torch.float32, (256, 384))])
def test_power_law_kernel_matches_plain(cuda, dtype, shape, n, sigma_y):
    """Kernel 11 in its three branches (Picard for n = 0.5 and 1.5, Newton
    with a yield stress, the Newtonian constant), 3 steps from a noisy
    sheared state."""
    from lbm_tpu_torch.kernels import power_law
    from lbm_tpu_torch.scenes.ulbm import double_shear_init

    R, C = shape
    m0, u = double_shear_init(R, C, 0.08, device=cuda, dtype=dtype)
    rng = np.random.default_rng(7)
    f = (d2q9.equilibrium(u, m0) * torch.as_tensor(
        rng.uniform(0.97, 1.03, (9, R, C)), dtype=dtype, device=cuda)).contiguous()
    kw = dict(cons_K=0.01, n=n, sigma_y=sigma_y)
    plain = collide_stream.make_fused_step(
        R, C, power_law.power_law_collide_fn(tau_min=0.52, tau_max=50.0, iters=8,
                                             dtype=dtype, **kw), dtype, 3)
    before = power_law.COLLIDE_STREAM_POWER_LAW.launches
    got = power_law.make_power_law_fused_step(R, C, dtype=dtype, substeps=3, **kw)(f)
    torch.cuda.synchronize()
    assert power_law.COLLIDE_STREAM_POWER_LAW.launches - before == 3
    assert (got - plain(f)).abs().max().item() <= TOL[dtype]


def _launch_variant(f):
    return channel.channel_variant(f, channel.ChannelVariant(**VARIANTS["gravity"]))


def _launch_trt(f):
    from lbm_tpu_torch.kernels import trt

    return trt.collide_stream_trt(f, 1 / 0.9, OM_MINUS)


def _launch_power_law(f):
    from lbm_tpu_torch.kernels import power_law

    return power_law.collide_stream_power_law(f, 0.01, 0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("launch", [_launch_variant, _launch_trt, _launch_power_law])
def test_kernels_9_to_11_reject_what_they_do_not_take(cuda, launch):
    f = torch.zeros((9, 8, 16), dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="CUDA tensor"):
        launch(f.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        launch(f[:, :, ::2])
    with pytest.raises(TypeError):
        launch(f.to(torch.int32))
    with pytest.raises(ValueError, match=r"\(9, R, C\)"):
        launch(f[:8].contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("name,kwargs", [
    ("gravity_channel", dict(H=21, W=21, T=300, tolerance=0.0)),
    ("specular_channel", dict(H=31, W=21, T=300)),
    ("free_stream", dict(H=30, W=24, T=100)),
    ("free_stream", dict(H=30, W=24, T=200, corner_consistent=True)),
    ("vertical_poiseuille", dict(H=21, W=17, T=300)),
    ("vertical_poiseuille", dict(H=21, W=21, T=300, incompressible=True)),
    ("trt_poiseuille", dict(H=21, W=21, T=300)),
])
def test_channel_variant_scenes_on_the_card_match_the_cpu(cuda, name, kwargs):
    """Each kernel-9 scene in float64, one launch per step, against the same
    scene on the CPU (the plain model step): 1e-12."""
    before = channel.CHANNEL_VARIANT.launches
    got = getattr(scene, name)(device=cuda, dtype=torch.float64, **kwargs)
    assert channel.CHANNEL_VARIANT.launches - before == got.steps
    want = getattr(scene, name)(device="cpu", dtype=torch.float64, **kwargs)
    assert got.steps == want.steps and got.f.is_cuda
    assert (got.f.cpu() - want.f).abs().max().item() <= 1e-12
    assert (got.u.cpu() - want.u).abs().max().item() <= 1e-12


@pytest.mark.cuda
def test_power_law_channel_on_the_card_matches_the_cpu(cuda):
    """The power-law channel has no kernel: plain tensor ops on the card,
    equal to the CPU run within 1e-10 (libdevice and the CPU's exp and log
    may differ by an ulp)."""
    kw = dict(H=4, W=41, T=400, dtype=torch.float64)
    got = scene.power_law_channel(device=cuda, **kw)
    want = scene.power_law_channel(device="cpu", **kw)
    assert got.steps == want.steps and got.f.is_cuda
    assert (got.f.cpu() - want.f).abs().max().item() <= 1e-10
