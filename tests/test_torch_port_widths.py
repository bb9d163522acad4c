"""Every layer width the JAX package's Pallas kernels take has a route of
hand kernels in the port (``ops/lstm_cuda.py:padded_width``,
``padded_parts`` and ``layer_route``), and the zero-padded route is the
unpadded layer.

* the grid: each layer shape at 1 <= H <= 288 for which
  ``intrepppid_tpu/ops/lstm_pallas_layer.py:pick_plan`` returns a plan, at
  the train step's shapes (400 rows; layer 0 at E = H in 5 weight groups,
  a stacked layer at E = 2H) and the serve dispatch's (800 rows, 1 group),
  T = 1500, f32 and bf16, names a hand kernel (a ``csrc/*.cu`` source) for
  each of the route's steps at its padded widths (H and each input part);
  the recurrence op takes every such H, on the CPU any H, and on the card
  every H up to 1024;
* the padded layer (units, input columns or both), run through the plain
  twins on the CPU as on the card, against the unpadded plain layer
  (values and gradients; ragged lengths, grouped ``w_hh``): 1e-6 x max(1,
  max|ref|) in f32 (the same sums, in another blocking) and 2^-8 x max(1,
  max|ref|) in bf16 (one bf16 rounding of a stream value);
* two-layer models at embedding 48, 50, 80, 100, 112 and 272 against the
  JAX package (``utils/convert.py:from_jax_params``, dropout off): the
  forward and one train step's gradients, to the tolerance of the port's
  other step tests (rtol 1e-4, atol 1e-5); the bf16 models at embedding 16,
  56, 72 and 160 against JAX in bf16 (each gradient within 2^-6 x its own
  max);
* past 288 units a layer (embedding 300 and 320, one and two layers, f32)
  the default backend takes the recurrence op, where JAX's "auto" takes its
  scan: the forward and one train step's gradients against JAX at 1e-4 x
  max(1, max|ref|).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intrepppid_tpu.models.factory import intrepppid_network as jax_network
from intrepppid_tpu.ops.lstm_pallas_layer import pick_plan
from intrepppid_tpu_torch.models.factory import intrepppid_network
from intrepppid_tpu_torch.ops import lstm as port_lstm
from intrepppid_tpu_torch.ops import lstm_cuda
from intrepppid_tpu_torch.ops.lstm import bidir_layer, bidir_layer_bwd
from intrepppid_tpu_torch.ops.lstm_recurrence import (
    fused_lstm_recurrence,
    recurrence_bwd,
    recurrence_fwd,
)
from intrepppid_tpu_torch.utils.convert import from_jax_params
from torch_port_threads import one_thread_one_cpu  # noqa: F401  (autouse)

DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
TOL = {torch.float32: 1e-6, torch.bfloat16: 2.0 ** -8}
# (rows, weight groups, input parts) of each layer shape of the grid
SHAPES = {"train layer 0": (400, 5, lambda H: [H]),
          "train stacked": (400, 1, lambda H: [H, H]),
          "serve layer 0": (800, 1, lambda H: [H]),
          "serve stacked": (800, 1, lambda H: [H, H])}


def jax_takes(B, G, E_parts, H, dtype):
    """Whether JAX's ``pick_plan`` gives the layer a Pallas plan (a stack
    threads 1 or 2 dy streams into a layer's backward)."""
    return any(pick_plan(B, 1500, H, G, DTYPES[dtype], E=sum(E_parts), nyparts=ny) is not None
               for ny in (1, 2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_every_width_jax_takes_names_hand_kernels(dtype):
    """Every H from 1 to 288 at the four shapes: where JAX has a Pallas
    plan, the port has a route at a padded shape (Hp >= H, each part at
    least its width, Hp within the wide kernels' 288), the route takes
    that shape as it is, and each of its steps names a hand kernel."""
    hand = set(lstm_cuda._SIGNATURES)
    taken = 0
    for H in range(1, 289):
        for what, (B, G, parts) in SHAPES.items():
            E_parts = parts(H)
            if not jax_takes(B, G, E_parts, H, dtype):
                continue
            taken += 1
            Hp = lstm_cuda.padded_width(E_parts, H, dtype)
            Ep = lstm_cuda.padded_parts(E_parts, H, dtype)
            route = lstm_cuda.layer_route(E_parts, H, dtype)
            assert lstm_cuda.padded_width(Ep, Hp, dtype) == Hp, (what, H, Hp, Ep)
            assert lstm_cuda.padded_parts(Ep, Hp, dtype) == Ep, (what, H, Hp, Ep)
            assert route == lstm_cuda.layer_route(Ep, Hp, dtype)
            assert H <= Hp <= 288 and (Hp == H or Hp % 16 == 0), (what, H, Hp)
            assert all(ep == e or (ep > e and ep % 8 == 0) for e, ep in zip(E_parts, Ep))
            if route == "resident":
                kernels = [lstm_cuda.fwd_kernel(Ep, Hp, dtype),
                           lstm_cuda.sweep_kernel(Ep, Hp, dtype)]
            else:
                kernels = [lstm_cuda.gates_kernel(Ep, Hp, dtype),
                           lstm_cuda.wide_fwd_kernel(Hp, dtype),
                           lstm_cuda.lite_kernel(Hp, dtype)]
            kernels.append(lstm_cuda.wgrad_kernel(Ep, Hp, dtype))
            assert set(kernels) <= hand, (what, H, kernels)
    # JAX has a Pallas plan for every shape of the grid up to H = 242 in f32
    # and 286 in bf16 (its scan past them)
    assert taken == (242 if dtype == torch.float32 else 286) * len(SHAPES)



@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lite_kernels_by_width_are_the_parents_but_bf16_at_288(dtype):
    """Every layer of the grid above (H from 1 to 288 at the four shapes)
    that takes the wide route names, at its padded shape, the lite sweep it
    named before the tensor-core instance at 288: the tensor-core sweep in
    bf16 at H = 128 and 256, the CUDA-core one at the other bf16 widths;
    except bf16 at H = 288, which the tensor-core sweep now takes (the
    layers of 257-288 units, embedding 272 among them), f32 at 128 to 288,
    which the f32 tensor-core sweep (three tf32 passes) takes, and 96 in
    either dtype, which the one-block sweeps with W_hh resident take (three
    tf32 passes in f32, one bf16 pass in bf16), and bf16 at 160, 192 and
    224, which the tensor-core sweep's second kernel (the one of 288, its
    items dealt over 8 warps) takes."""
    wide = set()
    for H in range(1, 289):
        for what, (B, G, parts) in SHAPES.items():
            E_parts = parts(H)
            try:
                route = lstm_cuda.layer_route(E_parts, H, dtype)
            except ValueError:
                continue
            if route != "wide":
                continue
            Hp = lstm_cuda.padded_width(E_parts, H, dtype)
            wide.add(Hp)
            bf16 = dtype == torch.bfloat16
            parent = "bilstm_bwd_lite_mma" if bf16 and Hp in (128, 256) else "bilstm_bwd_lite"
            want = "bilstm_bwd_lite_mma" if bf16 and Hp in (160, 192, 224, 288) else parent
            if not bf16 and Hp in (128, 160, 192, 224, 256, 288):
                want = "bilstm_bwd_lite_f32"
            if Hp == 96:
                want = "bilstm_bwd_lite_mma_resident" if bf16 else "bilstm_bwd_lite_f32_resident"
            assert lstm_cuda.lite_kernel(Hp, dtype) == want, (what, H, Hp)
    assert 288 in wide and 256 in wide and 96 in wide

def _grid_plans(dtype):
    """``(what, H) -> (route, Hp, Ep, kernels)`` over the grid of
    ``test_every_width_jax_takes_names_hand_kernels``: each step's kernel
    at the layer's padded shape, as that test names them."""
    plans = {}
    for H in range(1, 289):
        for what, (B, G, parts) in SHAPES.items():
            E_parts = parts(H)
            if not jax_takes(B, G, E_parts, H, dtype):
                continue
            route, Hp, Ep = lstm_cuda._layer_plan(tuple(E_parts), H, dtype)
            if route == "resident":
                kernels = (lstm_cuda.fwd_kernel(Ep, Hp, dtype),
                           lstm_cuda.sweep_kernel(Ep, Hp, dtype))
            else:
                kernels = (lstm_cuda.gates_kernel(Ep, Hp, dtype),
                           lstm_cuda.wide_fwd_kernel(Hp, dtype), lstm_cuda.lite_kernel(Hp, dtype))
            plans[what, H] = (route, Hp, Ep, kernels + (lstm_cuda.wgrad_kernel(Ep, Hp, dtype),))
    return plans


def _cuda_core_fwd_plan(E_parts, H, dtype):
    """ValueError for a shape the deleted ``csrc/bilstm_fwd.cu`` did not
    take (its ``launch_plan``: 256 threads of H units, 4 rows a thread,
    both weights resident in the compute dtype beside two f32 [x ; h]
    tiles, at most 4 input chunks a thread)."""
    size = torch.empty((), dtype=dtype).element_size()
    vec, E = 16 // size, sum(E_parts)
    if H % 4 or H > 256 or any(e <= 0 or e % vec for e in E_parts):
        raise ValueError(f"bilstm_fwd.cu took no E_parts={list(E_parts)}, H={H}")
    groups = 256 // H
    rows = 4 * groups
    a16 = lambda n: -(-n // 16) * 16  # noqa: E731
    smem = a16(E * 4 * H * size) + a16(H * 4 * H * size) + 2 * rows * (E + H) * 4
    if smem > lstm_cuda.SMEM_LIMIT or rows * E // vec > 4 * H * groups:
        raise ValueError(f"bilstm_fwd.cu took no E_parts={list(E_parts)}, H={H}")


def _cuda_core_wgrad_check(E_parts, H):
    """ValueError for a shape the deleted ``csrc/bilstm_wgrad.cu`` did not
    take (64-row gate tiles: 4H % 64 == 0; every width % 8 == 0)."""
    if (4 * H) % 64 or any(w <= 0 or w % 8 for w in (*E_parts, H)):
        raise ValueError(f"bilstm_wgrad.cu took no E_parts={list(E_parts)}, H={H}")


def _set_back(real, name, took):
    """``real`` (a dispatch) naming the deleted kernel ``name`` where it
    refuses a shape and ``took(*shape)`` passes."""
    def kernel(*shape):
        try:
            return real(*shape)
        except ValueError:
            took(*shape)
            return name
    return kernel


def _with_cuda_core_sweep(m):
    """Set back, on the monkeypatch context ``m``, the lite-sweep and
    wide-forward dispatch of the trees that still had
    ``csrc/bilstm_bwd_lite.cu`` and ``csrc/bilstm_fwd_wide.cu``: a width no
    tensor-core kernel takes, among those ``wide_check`` admits, named that
    CUDA-core kernel (the plans of a slice set back are those trees'
    plans)."""
    wide = lambda H, dtype: lstm_cuda.wide_check(H)  # noqa: E731
    m.setattr(lstm_cuda, "lite_kernel", _set_back(lstm_cuda.lite_kernel, "bilstm_bwd_lite", wide))
    m.setattr(lstm_cuda, "wide_fwd_kernel",
              _set_back(lstm_cuda.wide_fwd_kernel, "bilstm_fwd_wide", wide))


def _with_cuda_core_resident(m):
    """Set back, on the monkeypatch context ``m``, the resident forward's
    and the weight gradients' dispatch of the trees that still had
    ``csrc/bilstm_fwd.cu`` and ``csrc/bilstm_wgrad.cu`` (a shape no
    tensor-core kernel takes named that kernel where it took it), with the
    bf16 sweep's rule of those trees (``BWD_MMA_ANY_K_WIDTHS`` = ()): their
    plans, under which bf16 changes at ``ANY_K_SWEEP`` too."""
    m.setattr(lstm_cuda, "fwd_kernel",
              _set_back(lstm_cuda.fwd_kernel, "bilstm_fwd", _cuda_core_fwd_plan))
    m.setattr(lstm_cuda, "wgrad_kernel",
              _set_back(lstm_cuda.wgrad_kernel, "bilstm_wgrad",
                        lambda E_parts, H, dtype: _cuda_core_wgrad_check(E_parts, H)))
    m.setattr(lstm_cuda, "BWD_MMA_ANY_K_WIDTHS", ())


# the bf16 resident layers whose sweep left bilstm_bwd.cu for the tensor-core
# one when it took H = 16-64 at any E (layer 0 of 1-7 units; the stacked
# layers of 9-16 units, the bf16 model at embedding 16)
ANY_K_SWEEP = {("resident", 16, (8,)), ("resident", 16, (16, 16))}


def _changes(before, after):
    """``{(old kernel, new kernel): {(route, Hp, Ep), ..}}`` over the grid,
    asserting that no layer changes its route or padded shape."""
    changed = {}
    for key, (route, Hp, Ep, kernels, *_) in after.items():
        assert (route, Hp, Ep) == before[key][:3], key
        for a, b in zip(before[key][3], kernels):
            if a != b:
                changed.setdefault((a, b), set()).add((route, Hp, Ep))
    return changed


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_80_sweep_and_288_forward_change_no_other_plan(dtype, monkeypatch):
    """Over the grid above, every layer keeps the route and padded shape it
    had before the tensor-core sweep at E = H = 80 and the tensor-core wide
    forward at 288 (the plans with those two caps set back:
    ``BWD_MMA_MAX_H`` at ``MMA_MAX_H``, ``FWD_WIDE_MMA_WIDTHS`` without 288),
    and the same kernel at every step, except two: in bf16 the resident
    sweep at Hp = 80 (layer 0 of 65-80 units but 72, run at E = H = 80) is
    ``bilstm_bwd_mma`` where it was ``bilstm_bwd``, and the wide forward at
    Hp = 288 (257-288 units) ``bilstm_fwd_wide_mma`` where it was
    ``bilstm_fwd_wide``. f32 changes nothing."""
    try:
        with monkeypatch.context() as m:
            m.setattr(lstm_cuda, "BWD_MMA_MAX_H", lstm_cuda.MMA_MAX_H)
            m.setattr(lstm_cuda, "FWD_WIDE_MMA_WIDTHS",
                      tuple(h for h in lstm_cuda.FWD_WIDE_MMA_WIDTHS if h != 288))
            _with_cuda_core_sweep(m)
            lstm_cuda._layer_plan.cache_clear()
            before = _grid_plans(dtype)
        lstm_cuda._layer_plan.cache_clear()
        after = _grid_plans(dtype)
    finally:
        lstm_cuda._layer_plan.cache_clear()
    assert before.keys() == after.keys() and len(after) == (
        242 if dtype == torch.float32 else 286) * len(SHAPES)
    changed = {}
    for key, (route, Hp, Ep, kernels) in after.items():
        assert (route, Hp, Ep) == before[key][:3], key
        diff = {(a, b) for a, b in zip(before[key][3], kernels) if a != b}
        if diff:
            changed.setdefault(diff.pop(), set()).add((Hp, Ep))
            assert not diff, key
    if dtype == torch.float32:
        assert changed == {}
    else:
        assert changed == {("bilstm_bwd", "bilstm_bwd_mma"): {(80, (80,))},
                           ("bilstm_fwd_wide", "bilstm_fwd_wide_mma"): {
                               (288, (272,)), (288, (288,)), (288, (272, 272)),
                               (288, (288, 288))}}
        assert sum(1 for (what, H), p in after.items()
                   if p[3][1] == "bilstm_bwd_mma" and p[1] == 80) == 2 * 15


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_f32_lite_sweep_changes_no_other_plan(dtype, monkeypatch):
    """Over the grid above, every layer keeps the route and padded shape it
    had before the f32 tensor-core lite sweep (the plans with its widths
    emptied: ``LITE_F32_WIDTHS`` = ()), and the same kernel at every step,
    except one: in f32 the lite sweep at Hp = 128 to 288 is
    ``bilstm_bwd_lite_f32`` where it was ``bilstm_bwd_lite``. bf16 changes
    nothing; no f32 wide layer keeps the CUDA-core sweep (96 keeps its
    one-block sweep, which has no cap here)."""
    try:
        with monkeypatch.context() as m:
            m.setattr(lstm_cuda, "LITE_F32_WIDTHS", ())
            _with_cuda_core_sweep(m)
            lstm_cuda._layer_plan.cache_clear()
            before = _grid_plans(dtype)
        lstm_cuda._layer_plan.cache_clear()
        after = _grid_plans(dtype)
    finally:
        lstm_cuda._layer_plan.cache_clear()
    assert before.keys() == after.keys()
    changed, kept = set(), set()
    for key, (route, Hp, Ep, kernels) in after.items():
        assert (route, Hp, Ep) == before[key][:3], key
        diff = {(a, b) for a, b in zip(before[key][3], kernels) if a != b}
        if diff:
            assert diff == {("bilstm_bwd_lite", "bilstm_bwd_lite_f32")}, key
            changed.add(Hp)
        elif route == "wide" and kernels[2] == "bilstm_bwd_lite":
            kept.add(Hp)
    if dtype == torch.bfloat16:
        assert changed == set()
    else:
        assert changed == {128, 160, 192, 224, 256} and kept == set()
        assert lstm_cuda.lite_kernel(96, dtype) == "bilstm_bwd_lite_f32_resident"
        # 288 lies past JAX's f32 plans (242): the grid's widest f32 layer
        assert lstm_cuda.lite_kernel(288, dtype) == "bilstm_bwd_lite_f32"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_f32_resident_forward_and_lite_sweep_change_no_other_plan(dtype, monkeypatch):
    """Over the grid above, every layer keeps the route and padded shape it
    had before the f32 tensor-core forward took H = 80 and the one-block
    f32 lite sweep took H = 96 (the plans with those two caps set back:
    ``FWD_F32_MAX_H`` at 64, ``LITE_F32_RESIDENT_WIDTHS`` = ()), and the
    same kernel at every step, except two, both in f32: the resident
    forward at Hp = 80 (layer 0 of 65-80 units, run at E = 72 or 80) is
    ``bilstm_fwd_f32`` where it was ``bilstm_fwd``, and the lite sweep at
    Hp = 96 (the stacked layers of 65-96 units and layer 0 of 81-96)
    ``bilstm_bwd_lite_f32_resident`` where it was ``bilstm_bwd_lite``. bf16
    changes only the sweep of those trees at ``ANY_K_SWEEP``."""
    try:
        with monkeypatch.context() as m:
            m.setattr(lstm_cuda, "FWD_F32_MAX_H", 64)
            m.setattr(lstm_cuda, "LITE_F32_RESIDENT_WIDTHS", ())
            _with_cuda_core_sweep(m)
            _with_cuda_core_resident(m)
            lstm_cuda._layer_plan.cache_clear()
            before = _grid_plans(dtype)
        lstm_cuda._layer_plan.cache_clear()
        after = _grid_plans(dtype)
    finally:
        lstm_cuda._layer_plan.cache_clear()
    assert before.keys() == after.keys() and len(after) == (
        242 if dtype == torch.float32 else 286) * len(SHAPES)
    changed = {}
    for key, (route, Hp, Ep, kernels) in after.items():
        assert (route, Hp, Ep) == before[key][:3], key
        diff = {(a, b) for a, b in zip(before[key][3], kernels) if a != b}
        if diff:
            changed.setdefault(diff.pop(), set()).add((route, Hp, Ep))
            assert not diff, key
    if dtype == torch.bfloat16:
        assert changed == {("bilstm_bwd", "bilstm_bwd_mma"): ANY_K_SWEEP}
        return
    assert changed.keys() == {("bilstm_fwd", "bilstm_fwd_f32"),
                              ("bilstm_bwd_lite", "bilstm_bwd_lite_f32_resident")}
    assert changed["bilstm_fwd", "bilstm_fwd_f32"] == {("resident", 80, (72,)),
                                                       ("resident", 80, (80,))}
    assert {(route, Hp) for route, Hp, _ in changed[
        "bilstm_bwd_lite", "bilstm_bwd_lite_f32_resident"]} == {("wide", 96)}
    # the model at embedding 80: layer 0 and the stacked layer, each once
    assert after["train layer 0", 80][3][0] == "bilstm_fwd_f32"
    assert after["train stacked", 80][1:3] == (96, (80, 80))
    assert after["train stacked", 80][3][2] == "bilstm_bwd_lite_f32_resident"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_bf16_sweep_at_h_mod_16_eq_8_changes_no_other_plan(dtype, monkeypatch):
    """Over the grid above, every layer keeps the route and padded shape it
    had before the bf16 tensor-core sweep took H % 16 == 8 (the plans with
    ``BWD_MMA_ODD_WIDTHS`` = ()), and the same kernel at every step, except
    one, in bf16: the resident sweep at Hp = 8, 24, 40, 56 (layer 0 and the
    stacked layer) and 72 (layer 0: the model at embedding 72) is
    ``bilstm_bwd_mma`` where it was ``bilstm_bwd``. f32 changes nothing, and
    in bf16 the CUDA-core sweep keeps no resident layer (since the
    tensor-core sweep took H = 16 at any E: the next test)."""
    try:
        with monkeypatch.context() as m:
            m.setattr(lstm_cuda, "BWD_MMA_ODD_WIDTHS", ())
            lstm_cuda._layer_plan.cache_clear()
            before = _grid_plans(dtype)
        lstm_cuda._layer_plan.cache_clear()
        after = _grid_plans(dtype)
    finally:
        lstm_cuda._layer_plan.cache_clear()
    assert before.keys() == after.keys() and len(after) == (
        242 if dtype == torch.float32 else 286) * len(SHAPES)
    changed = {}
    for key, (route, Hp, Ep, kernels) in after.items():
        assert (route, Hp, Ep) == before[key][:3], key
        diff = {(a, b) for a, b in zip(before[key][3], kernels) if a != b}
        if diff:
            changed.setdefault(diff.pop(), set()).add((route, Hp, Ep))
            assert not diff, key
    if dtype == torch.float32:
        assert changed == {}
        return
    assert changed == {("bilstm_bwd", "bilstm_bwd_mma"): {
        ("resident", H, Ep) for H in (8, 24, 40, 56) for Ep in ((H,), (H, H))}
        | {("resident", 72, (72,))}}
    # the model at embedding 72: layer 0 on the tensor-core sweep, the stacked
    # layer on the wide route at 96 as before
    assert after["train layer 0", 72][3][1] == "bilstm_bwd_mma"
    assert after["train stacked", 72][:3] == ("wide", 96, (80, 80))
    assert {(Hp, Ep) for route, Hp, Ep, kernels in after.values()
            if route == "resident" and kernels[1] == "bilstm_bwd"} == set()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_bf16_sweep_at_any_k_changes_no_other_plan(dtype, monkeypatch):
    """Over the grid above, every layer keeps the route and padded shape it
    had before the bf16 tensor-core sweep took H = 16-64 whatever
    (E + H) % 32 (the plans with ``BWD_MMA_ANY_K_WIDTHS`` = ()), and the
    same kernel at every step, except one, in bf16: the resident sweep at
    (Hp, Ep) = (16, (8,)) (layer 0 of 1-7 units) and (16, (16, 16)) (the
    stacked layers of 9-16 units: the bf16 model at embedding 16) is
    ``bilstm_bwd_mma`` where it was ``bilstm_bwd``. f32 changes nothing.
    No layer of either dtype names ``bilstm_bwd``, ``bilstm_fwd`` or
    ``bilstm_wgrad`` now, and in f32 the recurrence op's weight gradient is
    the tensor-core one at every width it takes."""
    try:
        with monkeypatch.context() as m:
            m.setattr(lstm_cuda, "BWD_MMA_ANY_K_WIDTHS", ())
            lstm_cuda._layer_plan.cache_clear()
            before = _grid_plans(dtype)
        lstm_cuda._layer_plan.cache_clear()
        after = _grid_plans(dtype)
    finally:
        lstm_cuda._layer_plan.cache_clear()
    assert before.keys() == after.keys() and len(after) == (
        242 if dtype == torch.float32 else 286) * len(SHAPES)
    changed = {}
    for key, (route, Hp, Ep, kernels) in after.items():
        assert (route, Hp, Ep) == before[key][:3], key
        diff = {(a, b) for a, b in zip(before[key][3], kernels) if a != b}
        if diff:
            changed.setdefault(diff.pop(), set()).add((route, Hp, Ep))
            assert not diff, key
        assert not {"bilstm_bwd", "bilstm_fwd", "bilstm_wgrad"} & set(kernels), key
    if dtype == torch.float32:
        assert changed == {}
        assert {lstm_cuda.recurrence_wgrad_kernel(H, dtype)
                for H in range(32, lstm_cuda.REC_MAX_H + 1, 32)} == {"lstm_recurrence_wgrad_f32"}
        return
    assert changed == {("bilstm_bwd", "bilstm_bwd_mma"): {("resident", 16, (8,)),
                                                          ("resident", 16, (16, 16))}}
    assert {H for (what, H), p in after.items() if p[1:3] == (16, (8,))} == set(range(1, 8))
    # the bf16 model at embedding 16: both layers on the tensor-core sweep
    assert after["train layer 0", 16][3][1] == after["train stacked", 16][3][1] == "bilstm_bwd_mma"
    assert after["train stacked", 16][1:3] == (16, (16, 16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_bf16_resident_forward_and_lite_sweep_change_no_other_plan(dtype, monkeypatch):
    """Over the grid above, every layer keeps the route and padded shape it
    had before the bf16 tensor-core forward took E = H = 80 and 72 and the
    one-block bf16 lite sweep took H = 96 (the plans with those two set
    back: ``FWD_MMA_SHAPES`` up to H = 64, ``LITE_MMA_RESIDENT_WIDTHS`` =
    ()), and the same kernel at every step, except two, both in bf16: the
    resident forward at (Hp, Ep) = (80, (80,)) and (72, (72,)) (layer 0 of
    65-80 units) is ``bilstm_fwd_mma`` where it was ``bilstm_fwd``, and the
    lite sweep at Hp = 96 (the stacked layers of 65-96 units and layer 0 of
    81-96) ``bilstm_bwd_lite_mma_resident`` where it was
    ``bilstm_bwd_lite``; and the sweep of those trees at ``ANY_K_SWEEP``.
    f32 changes nothing; bf16 keeps ``bilstm_fwd.cu`` at no resident shape
    (since the tensor-core forward's instances with a k8 tail took
    H % 16 == 8 up to 56 and H = 48 at E = 80 and 112; the source is gone
    since)."""
    try:
        with monkeypatch.context() as m:
            m.setattr(lstm_cuda, "FWD_MMA_SHAPES",
                      tuple(s for s in lstm_cuda.FWD_MMA_SHAPES if s[0] <= lstm_cuda.MMA_MAX_H))
            m.setattr(lstm_cuda, "LITE_MMA_RESIDENT_WIDTHS", ())
            _with_cuda_core_sweep(m)
            _with_cuda_core_resident(m)
            lstm_cuda._layer_plan.cache_clear()
            before = _grid_plans(dtype)
        lstm_cuda._layer_plan.cache_clear()
        after = _grid_plans(dtype)
    finally:
        lstm_cuda._layer_plan.cache_clear()
    assert before.keys() == after.keys() and len(after) == (
        242 if dtype == torch.float32 else 286) * len(SHAPES)
    changed = {}
    for key, (route, Hp, Ep, kernels) in after.items():
        assert (route, Hp, Ep) == before[key][:3], key
        diff = {(a, b) for a, b in zip(before[key][3], kernels) if a != b}
        if diff:
            changed.setdefault(diff.pop(), set()).add((route, Hp, Ep))
            assert not diff, key
    if dtype == torch.float32:
        assert changed == {}
        return
    assert changed.keys() == {("bilstm_fwd", "bilstm_fwd_mma"),
                              ("bilstm_bwd_lite", "bilstm_bwd_lite_mma_resident"),
                              ("bilstm_bwd", "bilstm_bwd_mma")}
    assert changed["bilstm_bwd", "bilstm_bwd_mma"] == ANY_K_SWEEP
    assert changed["bilstm_fwd", "bilstm_fwd_mma"] == {("resident", 80, (80,)),
                                                       ("resident", 72, (72,))}
    assert {(route, Hp) for route, Hp, _ in changed[
        "bilstm_bwd_lite", "bilstm_bwd_lite_mma_resident"]} == {("wide", 96)}
    # the models at embedding 80 and 72: layer 0 and the stacked layer
    for width in (80, 72):
        assert after["train layer 0", width][3][:2] == ("bilstm_fwd_mma", "bilstm_bwd_mma")
        assert after["train stacked", width][:3] == ("wide", 96, (80, 80))
        assert after["train stacked", width][3][2] == "bilstm_bwd_lite_mma_resident"
    # what bilstm_fwd.cu keeps in bf16: no shape (ROADMAP B2.4)
    assert {(Hp, Ep) for route, Hp, Ep, kernels in after.values()
            if route == "resident" and kernels[0] == "bilstm_fwd"} == set()
    assert not any(p[3][2] == "bilstm_bwd_lite" and p[1] == 96 for p in after.values()
                   if p[0] == "wide")


# the bf16 resident shapes that took the tensor-core forward's instances
# with a k8 tail (and the <56, 56>, <56, 112>, <48, 80>, <8, 16> ones), and
# the f32 shapes that took the 64-row wgrad tile, from bilstm_fwd.cu and
# bilstm_wgrad.cu
K8_FORWARD_SHAPES = {(8, (8,)), (8, (8, 8)), (16, (8,)), (24, (24,)), (24, (24, 24)),
                     (40, (40,)), (40, (40, 40)), (48, (40, 40)), (48, (56, 56)), (56, (56,)),
                     (56, (56, 56))}
NARROW_WGRAD_SHAPES = {(16, (8,)), (16, (8, 8)), (16, (16,)), (16, (16, 16)), (48, (40,)),
                       (48, (40, 40)), (48, (48,)), (48, (48, 48)), (80, (72,)), (80, (80,))}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_k8_forward_narrow_wgrad_and_96_split_change_no_other_plan(dtype, monkeypatch):
    """Over the grid above, with the bf16 tensor-core forward's 11 newest
    instances, the f32 wgrad's 64-row tile (``WGRAD_F32_H_STEP`` at 32) and
    the whole wgrad at Hp = 96 on the bf16 wide route (``WGRAD_SPLIT_PAST_H``
    at 0) set back, every layer keeps its route and padded shape, and the
    same kernel at every step except: in bf16 the resident forward at the
    11 shapes of ``K8_FORWARD_SHAPES`` is ``bilstm_fwd_mma`` where it was
    ``bilstm_fwd``, and the wide layers at Hp = 96 take the weight
    gradients whole (``bilstm_wgrad_mma``) where they were split; in f32
    the wgrad at the 10 shapes of ``NARROW_WGRAD_SHAPES`` is
    ``bilstm_wgrad_f32`` where it was ``bilstm_wgrad``; and in bf16 the
    sweep of those trees at ``ANY_K_SWEEP`` (whose first layer changes its
    forward too). No layer of either dtype names ``bilstm_fwd`` or
    ``bilstm_wgrad`` now (both sources are gone)."""
    def plans():
        return {k: p + (lstm_cuda.wgrad_split(p[0], p[1], dtype),)
                for k, p in _grid_plans(dtype).items()}

    try:
        with monkeypatch.context() as m:
            m.setattr(lstm_cuda, "FWD_MMA_SHAPES", lstm_cuda.FWD_MMA_SHAPES[:9])
            m.setattr(lstm_cuda, "WGRAD_F32_H_STEP", 32)
            m.setattr(lstm_cuda, "WGRAD_SPLIT_PAST_H", 0)
            _with_cuda_core_resident(m)
            lstm_cuda._layer_plan.cache_clear()
            before = plans()
        lstm_cuda._layer_plan.cache_clear()
        after = plans()
    finally:
        lstm_cuda._layer_plan.cache_clear()
    assert before.keys() == after.keys() and len(after) == (
        242 if dtype == torch.float32 else 286) * len(SHAPES)
    changed = _changes(before, after)
    for key, (route, Hp, Ep, kernels, split) in after.items():
        if split != before[key][4]:
            changed.setdefault(("split", "whole"), set()).add((route, Hp, Ep))
        assert "bilstm_fwd" not in kernels and "bilstm_wgrad" not in kernels, key
    if dtype == torch.float32:
        assert changed == {("bilstm_wgrad", "bilstm_wgrad_f32"): {
            ("resident", Hp, Ep) for Hp, Ep in NARROW_WGRAD_SHAPES}}
        assert after["train layer 0", 80][3] == ("bilstm_fwd_f32", "bilstm_bwd_f32_onestage",
                                                 "bilstm_wgrad_f32")
        return
    assert changed.keys() == {("bilstm_fwd", "bilstm_fwd_mma"), ("split", "whole"),
                              ("bilstm_bwd", "bilstm_bwd_mma")}
    assert changed["bilstm_fwd", "bilstm_fwd_mma"] == {
        ("resident", Hp, Ep) for Hp, Ep in K8_FORWARD_SHAPES}
    assert changed["bilstm_bwd", "bilstm_bwd_mma"] == ANY_K_SWEEP
    assert {(route, Hp) for route, Hp, _ in changed["split", "whole"]} == {("wide", 96)}
    # the model at embedding 56: both layers on the tensor-core forward
    assert after["train layer 0", 56][3][0] == after["train stacked", 56][3][0] == "bilstm_fwd_mma"
    # the bf16 models at embedding 72 and 80: the stacked layer's wgrad whole
    for width in (72, 80):
        assert after["train stacked", width][1] == 96 and not after["train stacked", width][4]
    assert after["train layer 0", 160][4] and after["train stacked", 128][4]


def test_wgrad_split_by_width_and_dtype():
    """The bf16 wide route splits a layer's weight gradients (dW_ih on
    cuBLAS, dW_hh on the tensor-core kernel) past 96 units only: at 96 the
    whole kernel is the faster; f32 and the resident route never split."""
    bf16, f32 = torch.bfloat16, torch.float32
    assert lstm_cuda.WGRAD_SPLIT_PAST_H == 96
    for H in (128, 160, 192, 224, 256, 288):
        assert lstm_cuda.wgrad_split("wide", H, bf16)
        assert not lstm_cuda.wgrad_split("wide", H, f32)
    assert not lstm_cuda.wgrad_split("wide", 96, bf16)
    assert not lstm_cuda.wgrad_split("wide", 96, f32)
    for H in (16, 56, 64, 80):
        assert not lstm_cuda.wgrad_split("resident", H, bf16)


# Kernel slices that each took some widths from older kernels: the
# constants that set a slice back, and by dtype the only kernel changes it
# made, {(old, new): the padded widths Hp where the wide route changed}.
# First the f32 lite sweep at 160-224 with the one-block bf16 wide forward
# at 96, then the bf16 lite sweep with the f32 wide forward at 160-224, then
# the bf16 wide forward at 160-224, then the one-block f32 wide forward at
# 96. Each is set back on the lite-sweep dispatch of its time
# (``_with_cuda_core_sweep``).
WIDE_SLICES = {
    "f32_lite_160_224_bf16_fwd_96": (
        {"LITE_F32_WIDTHS": (128, 256, 288), "FWD_WIDE_MMA_RESIDENT_WIDTHS": ()},
        {torch.float32: {("bilstm_bwd_lite", "bilstm_bwd_lite_f32"): {160, 192, 224}},
         torch.bfloat16: {("bilstm_fwd_wide", "bilstm_fwd_wide_mma_resident"): {96}}}),
    "bf16_lite_f32_fwd_160_224": (
        {"LITE_MMA_WIDTHS": (128, 256, 288), "FWD_WIDE_F32_WIDTHS": (128, 256, 288)},
        {torch.float32: {("bilstm_fwd_wide", "bilstm_fwd_wide_f32"): {160, 192, 224}},
         torch.bfloat16: {("bilstm_bwd_lite", "bilstm_bwd_lite_mma"): {160, 192, 224}}}),
    "bf16_fwd_160_224": (
        {"FWD_WIDE_MMA_WIDTHS": (128, 256, 288)},
        {torch.float32: {},
         torch.bfloat16: {("bilstm_fwd_wide", "bilstm_fwd_wide_mma"): {160, 192, 224}}}),
    "f32_fwd_96": (
        {"FWD_WIDE_F32_RESIDENT_WIDTHS": ()},
        {torch.float32: {("bilstm_fwd_wide", "bilstm_fwd_wide_f32_resident"): {96}},
         torch.bfloat16: {}}),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel_slice", list(WIDE_SLICES))
def test_each_wide_kernel_slice_changes_no_other_plan(kernel_slice, dtype, monkeypatch):
    """Over the grid above, with one slice of ``WIDE_SLICES`` set back,
    every layer keeps its route and padded shape, and the same kernel at
    every step except those the slice names: f32 ``bilstm_bwd_lite`` →
    ``bilstm_bwd_lite_f32`` and bf16 ``bilstm_fwd_wide`` →
    ``bilstm_fwd_wide_mma_resident`` (the stacked layers of 65-96 units and
    layer 0 of 81-96 at Hp = 96), or f32 ``bilstm_fwd_wide`` →
    ``bilstm_fwd_wide_f32`` and bf16 ``bilstm_bwd_lite`` →
    ``bilstm_bwd_lite_mma`` at Hp = 160, 192 and 224 (layer 0 of 145-224
    units and the stacked layers run there), or bf16 ``bilstm_fwd_wide`` →
    ``bilstm_fwd_wide_mma`` at 160, 192 and 224, or f32 ``bilstm_fwd_wide``
    → ``bilstm_fwd_wide_f32_resident`` at Hp = 96. Today no wide layer takes
    the CUDA-core lite sweep (its source is gone) or the CUDA-core wide
    forward, in either dtype."""
    constants, changes = WIDE_SLICES[kernel_slice]
    try:
        with monkeypatch.context() as m:
            for name, value in constants.items():
                m.setattr(lstm_cuda, name, value)
                _with_cuda_core_sweep(m)
            lstm_cuda._layer_plan.cache_clear()
            before = _grid_plans(dtype)
        lstm_cuda._layer_plan.cache_clear()
        after = _grid_plans(dtype)
    finally:
        lstm_cuda._layer_plan.cache_clear()
    assert before.keys() == after.keys() and len(after) == (
        242 if dtype == torch.float32 else 286) * len(SHAPES)
    changed = {}
    for key, (route, Hp, Ep, kernels) in after.items():
        assert (route, Hp, Ep) == before[key][:3], key
        diff = {(a, b) for a, b in zip(before[key][3], kernels) if a != b}
        if diff:
            assert route == "wide", key
            changed.setdefault(diff.pop(), set()).add(Hp)
            assert not diff, key
    assert changed == changes[dtype]
    wide = [p for p in after.values() if p[0] == "wide"]
    assert {96, 160, 192, 224} <= {p[1] for p in wide}
    assert not any(p[3][2] == "bilstm_bwd_lite" for p in wide)
    assert not any(p[3][1] == "bilstm_fwd_wide" for p in wide)
    if dtype == torch.float32:
        assert after["train layer 0", 160][3][1:3] == ("bilstm_fwd_wide_f32",
                                                      "bilstm_bwd_lite_f32")
    else:
        assert after["train layer 0", 160][3][1:3] == ("bilstm_fwd_wide_mma",
                                                      "bilstm_bwd_lite_mma")
        for width in (80, 72):
            assert after["train stacked", width][3][1] == "bilstm_fwd_wide_mma_resident"


@pytest.mark.parametrize("E_parts,H,dtype,Hp,route", [
    ([80], 80, torch.float32, 80, "resident"),     # the one-stage f32 sweep
    ([80], 80, torch.bfloat16, 80, "resident"),    # the tensor-core sweep at E = H = 80
    ([80, 80], 80, torch.float32, 96, "wide"),
    ([80, 80], 80, torch.bfloat16, 96, "wide"),
    ([48, 48], 48, torch.float32, 48, "resident"),  # the f32 tensor-core sweep takes E = 96
    ([48, 48], 48, torch.bfloat16, 48, "resident"),  # parts at 56: fewer products than H = 64
    ([112], 112, torch.float32, 128, "wide"),
    ([112, 112], 112, torch.bfloat16, 128, "wide"),
    ([240], 240, torch.bfloat16, 256, "wide"),
    ([64], 64, torch.bfloat16, 64, "resident"),
    ([256, 256], 256, torch.float32, 256, "wide"),
])
def test_padded_width_and_route(E_parts, H, dtype, Hp, route):
    assert lstm_cuda.padded_width(E_parts, H, dtype) == Hp
    assert lstm_cuda.layer_route(E_parts, H, dtype) == route
    if (E_parts, H, dtype) == ([48, 48], 48, torch.bfloat16):
        assert lstm_cuda.padded_parts(E_parts, H, dtype) == (56, 56)
    if (E_parts, H, dtype) == ([80], 80, torch.float32):
        assert lstm_cuda.sweep_kernel(E_parts, H, dtype) == "bilstm_bwd_f32_onestage"
    if (E_parts, H, dtype) == ([80], 80, torch.bfloat16):
        assert lstm_cuda.sweep_kernel(E_parts, H, dtype) == "bilstm_bwd_mma"
    if (E_parts, H, dtype) == ([48, 48], 48, torch.float32):
        assert lstm_cuda.sweep_kernel(E_parts, H, dtype) == "bilstm_bwd_f32"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_recurrence_op_takes_every_width_to_256(dtype):
    """The op's widths (past 256 on the tensor-core kernels of 96-288 and
    those past 288): on the card every H up to 1024 runs at the next
    multiple of 32 on hand kernels, and past 1024
    the card's check raises, naming the limit; the CPU's plain twins take
    any H, unpadded past 1024."""
    hand = set(lstm_cuda._SIGNATURES)
    for H in list(range(1, 300)) + list(range(300, 1025, 29)) + [1024]:
        Hp = lstm_cuda.recurrence_width(H, dtype)
        assert Hp == max(32, -(-H // 32) * 32)
        assert {lstm_cuda.recurrence_sweep_kernel(Hp, dtype),
                lstm_cuda.recurrence_wgrad_kernel(Hp, dtype),
                lstm_cuda.recurrence_fwd_kernel(Hp, dtype)} <= hand
    for H in (1025, 1040, 4096):
        with pytest.raises(ValueError, match="H <= 1024 on the card"):
            lstm_cuda.recurrence_width(H, dtype)
        assert lstm_cuda.recurrence_width(H, dtype, on_card=False) == H
    with pytest.raises(ValueError, match="H % 32 == 0"):
        lstm_cuda.recurrence_check(1056, dtype)


def test_pad_gate_rows_keeps_each_gate_block_in_place():
    t = torch.arange(2 * 12, dtype=torch.float32).reshape(2, 12)  # H = 3
    p = lstm_cuda.pad_gate_rows(t, 3, 5, -1)
    assert p.shape == (2, 20)
    for q in range(4):
        assert torch.equal(p[:, 5 * q:5 * q + 3], t[:, 3 * q:3 * q + 3])
        assert torch.all(p[:, 5 * q + 3:5 * q + 5] == 0)
    assert torch.equal(lstm_cuda.unpad_gate_rows(p, 3, 5, -1), t)


def layer_case(E_parts, H, G, dtype, seed, T=9, B=8):
    rng = np.random.default_rng(seed)

    def u(*shape, scale=1.0):
        return torch.from_numpy((rng.random(shape, dtype=np.float32) * 2 - 1) * scale)

    parts = tuple(u(T, B, e).to(dtype) for e in E_parts)
    w_ih = u(2, 4 * H, sum(E_parts), scale=H ** -0.5).to(dtype)
    w_hh = u(2, G, 4 * H, H, scale=H ** -0.5).to(dtype)
    bias = u(2, 4 * H)
    lengths = torch.tensor([T, 0, 3, 1, T, 5, 7, 2][:B], dtype=torch.int32)
    ny = 2 if len(E_parts) == 1 else 1
    dy = [u(T, B, H).to(dtype) for _ in range(2 * ny)]
    return parts, lengths, w_ih, w_hh, bias, tuple(dy[:ny]), tuple(dy[ny:]), u(2, B, H), \
        u(2, B, H)


def assert_within(got, want, tol, what):
    for n, (a, b) in enumerate(zip(got, want)):
        a, b = a.detach().float(), b.detach().float()
        assert a.shape == b.shape, (what, n)
        err = float((a - b).abs().max())
        assert err <= tol * max(1.0, float(b.abs().max())), (what, n, err)


@pytest.mark.parametrize("E_parts,H,G", [([80, 80], 80, 1), ([112], 112, 2), ([112, 112], 112, 1),
                                         ([10], 10, 2), ([50], 50, 4), ([100], 100, 2),
                                         ([100, 100], 100, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_padded_layer_equals_unpadded_plain_layer(E_parts, H, G, dtype):
    """``layer_fwd`` and ``layer_bwd`` on the CPU run the plain twins at
    the padded shape (units; and at embedding 10, 50 and 100 input columns
    too, ``padded_parts``); their results equal the plain layer at H."""
    assert lstm_cuda.padded_width(E_parts, H, dtype) > H
    if H in (10, 50, 100):
        assert lstm_cuda.padded_parts(E_parts, H, dtype) != tuple(E_parts)
    parts, lengths, w_ih, w_hh, bias, dyf, dyb, dhn, dcn = layer_case(E_parts, H, G, dtype, H)
    got = lstm_cuda.layer_fwd(parts, lengths, w_ih, w_hh, bias, dtype, with_states=True)
    want = bidir_layer(parts, lengths, w_ih, w_hh, bias, dtype, with_states=True)
    assert_within(got, want, TOL[dtype], "forward")
    assert_within(lstm_cuda.layer_fwd(parts, lengths, w_ih, w_hh, bias, dtype), want[:4],
                  TOL[dtype], "eval forward")
    hs_f, hs_b, _, _, cs_f, cs_b = want
    args = (parts, lengths, w_ih, w_hh, bias, hs_f, hs_b, cs_f, cs_b, dyf, dyb, dhn, dcn, dtype)
    got = lstm_cuda.layer_bwd(*args)
    want = bidir_layer_bwd(*args)
    assert_within(list(got[0]) + list(got[1]) + list(got[2:]),
                  list(want[0]) + list(want[1]) + list(want[2:]), TOL[dtype], "backward")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_padded_recurrence_op_equals_unpadded_plain_op(dtype):
    """``fused_lstm_recurrence`` at H = 80 runs at 96 (zero units in every
    gate block of ``xg`` and ``w``); its outputs and the gradients of ``xg``
    and ``w`` equal the plain op's at 80."""
    T, D, B, G, H = 7, 2, 6, 2, 80
    assert lstm_cuda.recurrence_width(H, dtype) == 96
    rng = np.random.default_rng(1)

    def u(*shape, scale=1.0):
        return torch.from_numpy((rng.random(shape, dtype=np.float32) * 2 - 1) * scale)

    xg = u(T, D, B, 4 * H)
    w = u(D, G, H, 4 * H, scale=H ** -0.5).to(dtype)
    valid = torch.from_numpy(rng.random((T, D, B)) > 0.3)
    dhs, dhn, dcn = u(T, D, B, H), u(D, B, H), u(D, B, H)
    xg_r, w_r = xg.clone().requires_grad_(), w.clone().requires_grad_()
    hs, hn, cn = fused_lstm_recurrence(xg_r, valid, w_r, G, dtype)
    torch.autograd.backward((hs, hn, cn), (dhs, dhn, dcn))
    want_hs, want_cs, want_hn, want_cn = recurrence_fwd(xg, valid, w, G, dtype)
    assert_within((hs, hn, cn), (want_hs, want_hn, want_cn), TOL[dtype], "forward")
    dxg, dw = recurrence_bwd(xg, valid, w, want_hs, want_cs, dhs, dhn, dcn, G, dtype)
    assert_within((xg_r.grad, w_r.grad), (dxg, dw), TOL[dtype], "backward")


@pytest.mark.parametrize("embedding", [48, 50, 80, 100, 112, 272, 16])
def test_two_layer_model_matches_jax(embedding):
    """A two-layer model (the factory's default) at embedding 48, 50, 80,
    100, 112, 272 and 16 (layer 0 at E = H = 16 and the stacked layer at
    16 + 16, two of the f32 wgrad's 64-row tile shapes; 48's are two more),
    f32, dropout off: the eval step's loss and aux values (the eval
    forward) and one train step's loss, aux values and every gradient
    against JAX ``step(train=True)`` (with every dropout rate 0 its forward
    is the eval forward)."""
    vocab, pairs, T = 30, 2, 8
    kw = dict(vocab_size=vocab, embedding_size=embedding, num_epochs=5,
              rnn_dropout_rate=0.0, embedding_droprate=0.0, do_rate=0.0)
    jnet = jax_network(4, **kw)
    params = jax.tree_util.tree_map(np.array, jnet.init(jax.random.PRNGKey(embedding)))
    net = intrepppid_network(4, device="cpu", **kw)
    net.load_state_dict(from_jax_params(params))
    rng = np.random.default_rng(embedding)

    def ids():
        a = rng.integers(1, vocab, (pairs, T)).astype(np.int32)
        for i, n in enumerate([T, 3]):
            a[i, n:] = 0
        return a

    batch = {k: ids() for k in ("p1", "p2", "anchor", "positive", "negative")}
    batch["label"] = np.array([1, 0], np.int32)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    (jl, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jnet.step(p, jbatch, jax.random.PRNGKey(0), train=True), has_aux=True))(jp)
    with torch.no_grad():
        _, eval_aux = net.step(tb, torch.Generator().manual_seed(0), train=False)
    loss, aux = net.step(tb, torch.Generator().manual_seed(0), train=True)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    for k, v in jaux.items():
        np.testing.assert_allclose(float(aux[k]), float(v), rtol=1e-5, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(float(eval_aux[k]), float(v), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, jgrads))
    assert sum(n.startswith("encoder.lstm.1.") for n in want) == 4
    for name, p in net.named_parameters():
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(got.numpy(), want[name].numpy(), atol=1e-5, rtol=1e-4,
                                   err_msg=name)


def _bf16_model_matches_jax(embedding):
    """The bf16 two-layer model at ``embedding`` against JAX with
    ``compute_dtype=bfloat16`` on the same numpy weights, dropout off: the
    eval step's and one train step's loss and aux values to rtol 1e-5, and
    every gradient within 2^-6 x max|ref| of its own parameter, plus 1e-7
    for the gradients that are 0."""
    vocab, pairs, T = 30, 2, 8
    kw = dict(vocab_size=vocab, embedding_size=embedding, num_epochs=5,
              rnn_dropout_rate=0.0, embedding_droprate=0.0, do_rate=0.0)
    jnet = jax_network(4, compute_dtype=jnp.bfloat16, **kw)
    params = jax.tree_util.tree_map(np.array, jnet.init(jax.random.PRNGKey(embedding)))
    net = intrepppid_network(4, device="cpu", compute_dtype=torch.bfloat16, **kw)
    net.load_state_dict(from_jax_params(params))
    rng = np.random.default_rng(embedding)

    def ids():
        a = rng.integers(1, vocab, (pairs, T)).astype(np.int32)
        for i, n in enumerate([T, 3]):
            a[i, n:] = 0
        return a

    batch = {k: ids() for k in ("p1", "p2", "anchor", "positive", "negative")}
    batch["label"] = np.array([1, 0], np.int32)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    (jl, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jnet.step(p, jbatch, jax.random.PRNGKey(0), train=True), has_aux=True))(jp)
    with torch.no_grad():
        _, eval_aux = net.step(tb, torch.Generator().manual_seed(0), train=False)
    loss, aux = net.step(tb, torch.Generator().manual_seed(0), train=True)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    for k, v in jaux.items():
        np.testing.assert_allclose(float(aux[k]), float(v), rtol=1e-5, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(float(eval_aux[k]), float(v), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, jgrads))
    assert sum(n.startswith("encoder.lstm.1.") for n in want) == 4
    for name, p in net.named_parameters():
        got = (p.grad if p.grad is not None else torch.zeros_like(p)).float().numpy()
        ref = want[name].float().numpy()
        err = float(np.abs(got - ref).max())
        assert err <= 2.0 ** -6 * float(np.abs(ref).max()) + 1e-7, (name, err)


def test_two_layer_bf16_model_at_embedding_72_matches_jax():
    """The bf16 two-layer model at embedding 72 (layer 0 at E = H = 72, the
    tensor-core forward's and sweep's <72, 72> shape; the stacked layer run
    at 96, the one-block bf16 lite sweep's) against JAX with
    ``compute_dtype=bfloat16`` on the same numpy weights, dropout off: the
    eval step's and one train step's loss and aux values to rtol 1e-5 (the
    same bf16 roundings of the same values; measured equal), and every
    gradient within 2^-6 x max|ref| of its own parameter, plus 1e-7 for the
    gradients that are 0 (four bf16 ulps at the gradient's scale: the port
    and JAX round the streams in bf16 at other places and sum in f32 in
    another order; measured at most 5.9e-3 x max|ref|, layer 0's w_hh)."""
    _bf16_model_matches_jax(72)


def test_two_layer_bf16_model_at_embedding_56_matches_jax():
    """The bf16 two-layer model at embedding 56 (layer 0 at E = H = 56, the
    stacked layer at 56 + 56: the tensor-core forward's <56, 56> and
    <56, 112> instances, K = 112 and 168, the latter ending in a k8 step;
    the sweep's H % 16 == 8 instances) against JAX in bf16, dropout off,
    with the tolerances of the model at embedding 72: loss and aux to rtol
    1e-5, every gradient within 2^-6 x max|ref| + 1e-7. On the CPU the port
    runs the kernels' plain twins along the same routes."""
    _bf16_model_matches_jax(56)


def test_two_layer_bf16_model_at_embedding_16_matches_jax():
    """The bf16 two-layer model at embedding 16 (layer 0 at E = H = 16; the
    stacked layer at 16 + 16, K = 48, the tensor-core sweep's <16, 32>
    shape, run to 64 over zero columns) against JAX in bf16, dropout off,
    with the tolerances of the model at embedding 72: loss and aux to rtol
    1e-5, every gradient within 2^-6 x max|ref| + 1e-7. On the CPU the port
    runs the kernels' plain twins along the same routes."""
    assert lstm_cuda.sweep_kernel([16, 16], 16, torch.bfloat16) == "bilstm_bwd_mma"
    _bf16_model_matches_jax(16)


def test_two_layer_bf16_model_at_embedding_160_matches_jax():
    """The bf16 two-layer model at embedding 160 (both layers on the wide
    route at H = 160: the bf16 wide forward's kernel for uneven unit groups,
    the bf16 lite sweep's, the weight gradients split as the JAX lite mode
    splits them) against JAX in bf16, dropout off, with the tolerances of
    the model at embedding 72: loss and aux to rtol 1e-5, every gradient
    within 2^-6 x max|ref| + 1e-7. On the CPU the port runs the kernels'
    plain twins along the same routes."""
    _bf16_model_matches_jax(160)


@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("embedding", [300, 320])
def test_model_past_288_on_the_default_backend_matches_jax(embedding, layers):
    """Past 288 units a layer the port's default backend ("auto") runs the
    recurrence op (``resolve_backend`` by the stack's widest layer), where
    JAX's "auto" runs its scan: a model at embedding 300 and 320, one and
    two layers, f32, dropout off, against JAX on the same numpy weights:
    the eval forward's and one train step's loss and aux values, and every
    gradient, at 1e-4 x max(1, max|ref|). The layer backend named
    explicitly still refuses such a layer."""
    assert port_lstm.DEFAULT_BACKEND == "auto"
    assert port_lstm.resolve_backend("auto", embedding) == "recurrence"
    assert port_lstm.resolve_backend("auto", 288) == "layer"
    vocab, pairs, T = 30, 2, 6
    kw = dict(vocab_size=vocab, embedding_size=embedding, rnn_num_layers=layers, num_epochs=5,
              rnn_dropout_rate=0.0, embedding_droprate=0.0, do_rate=0.0)
    jnet = jax_network(4, **kw)
    params = jax.tree_util.tree_map(np.array, jnet.init(jax.random.PRNGKey(embedding + layers)))
    net = intrepppid_network(4, device="cpu", **kw)
    net.load_state_dict(from_jax_params(params))
    rng = np.random.default_rng(embedding + layers)

    def ids():
        a = rng.integers(1, vocab, (pairs, T)).astype(np.int32)
        a[1, 3:] = 0
        return a

    batch = {k: ids() for k in ("p1", "p2", "anchor", "positive", "negative")}
    batch["label"] = np.array([1, 0], np.int32)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    (jl, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jnet.step(p, jbatch, jax.random.PRNGKey(0), train=True), has_aux=True))(jp)

    def close(got, want, what):
        err = float(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max())
        assert err <= 1e-4 * max(1.0, float(np.abs(np.asarray(want)).max())), (what, err)

    with torch.no_grad():
        _, eval_aux = net.step(tb, torch.Generator().manual_seed(0), train=False)
    loss, aux = net.step(tb, torch.Generator().manual_seed(0), train=True)
    loss.backward()
    close(float(loss.detach()), float(jl), "loss")
    for k, v in jaux.items():
        close(float(aux[k]), float(v), k)
        close(float(eval_aux[k]), float(v), f"eval {k}")
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, jgrads))
    assert sum(n.startswith(f"encoder.lstm.{layers - 1}.") for n in want) == 4
    for name, p in net.named_parameters():
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        close(got.numpy(), want[name].numpy(), name)
    lp = [{k: t.detach() for k, t in layer.items()}
          for layer in net.encoder.lstm_weights(False, 1, None)]
    with pytest.raises(ValueError, match="no bilstm route takes this layer"):
        port_lstm.bilstm(lp, torch.zeros(2, T, embedding), None, torch.float32, backend="layer")
