"""The plain reference against the port's plain path (its CPU versions of
every kernel) at small configurations of the family, float32 both, through
the generation driver: the numbers it judges are rounding."""

import time

import pytest
import torch

from perfbench import harness
from perfbench.drivers import generation, training

from _small import small_cell

VARIANTS = {
    "isolated_legacy": dict(map3d_mode="isolated", legacy_mode=True),
    "mixed": dict(map3d_mode="mixed", legacy_mode=False),
    "all_nano": dict(map3d_mode="all", legacy_mode=False, synthesis_blocks=3, mod_blocks=[0],
                     neural_field_blocks=2, hidden_dim=16, latent_dim=16, feature_dim=16),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_reference_matches_port_plain_path(variant):
    cell = small_cell(**VARIANTS[variant])
    rec = generation.run(cell, 2**31 + 5, 0.2, False, torch.device("cpu"),
                         time.perf_counter())
    assert rec.failed == 0 and len(rec.requests) >= 1
    for k, v in rec.checks.items():
        assert v < 2e-5, (k, v)


def test_draws_and_weights_repeat_from_the_seed():
    meta = harness.step_meta(small_cell().config)
    from perfbench.reference.weights import generator_leaves, make_state

    leaves = generator_leaves(meta)
    a = make_state(leaves, torch.Generator().manual_seed(9), "cpu")
    b = make_state(leaves, torch.Generator().manual_seed(9), "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert float(a["neural_field.sigma_layer.bias"]) == 0.5
    p1, p2 = generation.pose_params(2**40 + 1, 4), generation.pose_params(2**40 + 1, 4)
    assert (p1[0] == p2[0]).all() and p1[0].shape == (4, 24, 3)


def test_weights_cover_the_port_state():
    """The benchmark's leaves are exactly the port generator's state."""
    from threedhumangan_tpu_torch.models.generator import Map3DGenerator
    from perfbench.reference.weights import generator_leaves

    meta = dict(harness.step_meta(harness.Spec().cell("gen.map3dbn512l.b8").config),
                dataset_length=4)
    with torch.device("meta"):
        sd = Map3DGenerator(meta).state_dict()
    leaves = {k: tuple(s) for k, s, _, _ in generator_leaves(meta)}
    assert leaves == {k: tuple(v.shape) for k, v in sd.items()}


def test_training_reference_matches_port_plain_path():
    """Three pairs of the port's ``Trainer`` (MAP3DBN_TINY, float32, its
    plain kernels) against the training reference.  Rounding alone parts
    them, but Adam at beta1 0 moves every element by about its learning
    rate whatever the size of its gradient, so the elements whose gradient
    is round-off (the biases in front of a batch norm) move apart and the
    later steps' losses and changes drift by some 1e-4 and 1e-2 (seed
    2**31 + 7: loss 6.5e-5, first gradient 2.2e-3, change 2.4e-2; seed 3:
    2.2e-7, 1.5e-6, 4.0e-4)."""
    cell = small_cell("train.map3dbn.b32", use_mixed_precision=False)
    rec = training.run(cell, 2**31 + 7, 0.2, False, torch.device("cpu"), time.perf_counter())
    n = rec.notes["numbers"]
    assert rec.failed == 0 and len(rec.requests) >= 1
    assert n["loss_gap"] < 1e-3 and n["grad_gap"] < 1e-2 and n["change_gap"] < 0.1, n
    assert n["loss1_gap"] < 1e-6 and n["grad_median_gap"] < 1e-5, n


def test_discriminator_weights_cover_the_port_state():
    from threedhumangan_tpu_torch.models.discriminator import UNetDiscriminator
    from perfbench.reference.discriminator import discriminator_leaves

    meta = harness.step_meta(harness.Spec().cell("train.map3dbn.b32").config)
    with torch.device("meta"):
        sd = UNetDiscriminator(meta).state_dict()
    leaves = {k: tuple(s) for k, s, _, _ in discriminator_leaves(meta)}
    assert leaves == {k: tuple(v.shape) for k, v in sd.items()}


def test_training_batches_repeat_the_port_loader():
    """The reference's batches are the port's synthetic loader's, by index
    and by value."""
    from threedhumangan_tpu_torch.data.dataset import get_dataset_distributed
    from threedhumangan_tpu_torch.models.smpl import SMPLModel
    from perfbench.reference import smpl as ref_smpl
    from perfbench.reference import training as ref

    meta = harness.step_meta(small_cell("train.map3dbn.b32").config)
    arrays = ref_smpl.synthetic_smpl_arrays(num_verts=384, num_faces=512)
    t = lambda k: torch.as_tensor(arrays[k])
    model = SMPLModel(v_template=t("v_template"), shapedirs=t("shapedirs"),
                      posedirs=t("posedirs"), J_regressor=t("J_regressor"),
                      parents=arrays["parents"], lbs_weights=t("lbs_weights"),
                      faces=arrays["faces"])
    kw = {k: v for k, v in meta.items()
          if k not in ("batch_size", "dataset", "name", "smpl_model")}
    loader, _ = get_dataset_distributed(meta["dataset"], 1, 0, 2, smpl_model=model, **kw)
    got = [b for b in loader(seed=0, shuffle=True)]
    for k, b in enumerate(got):
        idx = ref.batch_indices(meta["dataset_length"], 2, k)
        assert (b["indices"] == idx).all()
        mine = ref.synthetic_batch(idx, arrays, meta, "cpu")
        for key in ("images", "vertices", "fk_matrices", "skeletons_xyz"):
            assert torch.allclose(torch.as_tensor(b[key]), mine[key], atol=1e-5), key
        assert (torch.as_tensor(b["body_segments"]) == mine["body_segments"]).all()
