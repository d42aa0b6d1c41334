"""Model parity of the PyTorch port (sipmask_tpu_torch) with the JAX package:
the weight bridge, the initialisation, and the backbone, FPN, head and
detector outputs on the same weights, at golden's shrunk config, f32 on the
CPU (where K1 and K4 run their plain versions)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from _torch_parity import (assert_close, bumped_state_dict, images,
                           jax_variables, nhwc, shrunk_cfg)
from sipmask_tpu.config import get_config
from sipmask_tpu.models import build_model as j_build_model
from sipmask_tpu.utils.torch_convert import flax_to_torch_names
from sipmask_tpu_torch.models.detector import build_model
from sipmask_tpu_torch.utils.convert import init_weights, params_from_jax

# Relative to the largest magnitude of each output: f32 convolutions summed
# in another order (XLA vs ATen) through ~60 layers, and GroupNorm's
# single-pass variance, which amplifies rounding where a group is small
HEAD_REL = 1e-4


@pytest.fixture(scope="module")
def outputs():
    """(port outputs, JAX outputs) of every stage on one image batch."""
    cfg = shrunk_cfg()
    model = build_model(cfg.model).eval()
    variables = jax_variables(bumped_state_dict(model))
    model.load_state_dict(params_from_jax(variables["params"],
                                          variables["constants"]))
    x = images(2, 128, 160)

    def stages(m, x):
        c = m.backbone(x)
        p = m.neck(c)
        return c, p, m.head(p)

    jm = j_build_model(cfg.model)
    want = jax.jit(lambda v, x: jm.apply(v, x, method=stages))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
        c = model.backbone(xt)
        p = model.neck(c)
        got = (c, p, model.bbox_head(p))
    return got, jax.tree_util.tree_map(np.asarray, want)


def test_params_from_jax_names_and_layouts():
    """Full-size flagship: the bridge gives exactly the port's state_dict
    keys and shapes, and the same names and values as the JAX package's own
    flax_to_torch_names."""
    cfg = get_config("sipmask_r50_fpn_gn_1x")
    shapes = jax.eval_shape(j_build_model(cfg.model).init,
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3), jnp.float32))
    rng = np.random.RandomState(0)

    def filled(tree):
        flat = traverse_util.flatten_dict(tree)
        return traverse_util.unflatten_dict(
            {k: np.asarray(rng.randn(*v.shape), np.float32)
             for k, v in flat.items()})

    params, constants = filled(shapes["params"]), filled(shapes["constants"])
    sd = params_from_jax(params, constants)
    port = build_model(cfg.model).state_dict()
    assert set(sd) == set(port), set(sd) ^ set(port)
    for k, v in port.items():
        assert tuple(sd[k].shape) == tuple(v.shape), k
    want = flax_to_torch_names(params, constants)
    assert set(want) == set(sd)
    for k, v in want.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)


def test_init_weights_schemes_and_seed():
    cfg = shrunk_cfg()
    a, b, c = (build_model(cfg.model) for _ in range(3))
    init_weights(a, torch.Generator().manual_seed(1))
    init_weights(b, torch.Generator().manual_seed(1))
    init_weights(c, torch.Generator().manual_seed(2))
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["bbox_head.fcos_cls.weight"],
                           sc["bbox_head.fcos_cls.weight"])
    head = a.bbox_head
    assert torch.all(head.feat_align.conv_offset.weight == 0)
    np.testing.assert_allclose(head.fcos_cls.bias.detach().numpy(),
                               -np.log(99.0), rtol=1e-6)
    assert abs(float(head.sip_cof.weight.detach().std()) - 0.001) < 2e-4
    assert abs(float(head.fcos_reg.weight.detach().std()) - 0.01) < 2e-3
    w = a.backbone.layer1[0].conv2.weight.detach()     # fan_out = 64*9
    assert abs(float(w.std()) - np.sqrt(2 / 576)) < 0.01
    bound = np.sqrt(6 / ((2048 + 32) * 1))             # xavier, lateral C5
    lat = a.neck.lateral_convs[2].conv.weight.detach()
    assert float(lat.abs().max()) <= bound


def test_unported_configs_raise():
    from sipmask_tpu.config import _r
    for cfg in (get_config("sipmask_x101_fpn_gn_ms_2x"),
                get_config("sipmask_hrnet_w32_fpn_gn_1x"),
                _r(get_config("sipmask_x101_fpn_gn_ms_2x"), "model",
                   compute_dtype="bfloat16"),
                _r(get_config("sipmask_hrnet_w32_fpn_gn_1x"), "model",
                   compute_dtype="bfloat16")):
        with pytest.raises(NotImplementedError):
            build_model(cfg.model)


def test_backbone_matches_jax(outputs):
    (got, _, _), (want, _, _) = outputs
    assert len(got) == len(want) == 4
    for i, (g, w) in enumerate(zip(got, want)):
        assert_close(nhwc(g), w, 1e-5, f"C{i + 2}")


def test_fpn_matches_jax(outputs):
    (_, got, _), (_, want, _) = outputs
    assert len(got) == len(want) == 5
    for i, (g, w) in enumerate(zip(got, want)):
        assert_close(nhwc(g), w, 1e-5, f"P{i + 3}")


@pytest.mark.parametrize("key", ["cls_scores", "bbox_preds", "centernesses",
                                 "cof_preds"])
def test_head_levels_match_jax(outputs, key):
    (_, _, got), (_, _, want) = outputs
    assert len(got[key]) == len(want[key]) == 5
    for lvl, (g, w) in enumerate(zip(got[key], want[key])):
        assert_close(nhwc(g), w, HEAD_REL, f"{key}[{lvl}]")


def test_basis_masks_match_jax(outputs):
    (_, _, got), (_, _, want) = outputs
    assert got["feat_masks"].shape[2:] == (64, 80)
    assert_close(nhwc(got["feat_masks"]), want["feat_masks"], HEAD_REL)

