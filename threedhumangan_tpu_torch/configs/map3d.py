"""Training configurations for the Map3D generator family (the port's copy
of ``threedhumangan_tpu/configs/map3d.py``, same values).

Integer keys are curriculum step thresholds carrying {batch_size,
batch_split, gen_lr, disc_lr}; string keys are static hyperparameters;
``phases`` is an 8-entry list cycled per step (step % 8) toggling camera
rotation and R1 regularization.  Comments on TPU measurements are the JAX
package's and describe that package's runs.
"""

import math


def _phases():
    # (rotate, do_r1) per phase slot; reference configs/map3d.py:10-19.
    pattern = [
        (False, False),
        (True, False),
        (True, False),
        (False, True),
        (False, False),
        (True, False),
        (False, False),
        (True, True),
    ]
    return [
        {
            "name": "uncond",
            "uncond": True,
            "rotate": rotate,
            "gen_modal": "rgbs",
            "do_r1": do_r1,
        }
        for rotate, do_r1 in pattern
    ]


def _common():
    return {
        "trainer": "PhaseTrainer",
        "phases": _phases(),
        "2d_coords_input": True,
        "2d_semantic_input": False,
        "2d_latent_input": False,
        "neural_field_latent_input": False,
        "use_mixed_precision": True,
        "lock_view_dependence": True,
        # polynomial sine in the SIREN (ops/raymarch.py fast_sin)
        "fast_math": True,
        "num_steps": 32,
        "ray_start": -0.5,
        "ray_end": 0.55,
        "side_length": 2.85,
        "depth_length": 1.05,
        "vis_rotate": math.pi / 6,
        "fade_steps": 1,
        "sample_dist": "gaussian",
        "h_stddev": 0.4,
        "v_stddev": 0.1,
        "h_mean": 0,
        "v_mean": 0,
        "coordinate_mode": "fix_body",
        "betas": (0, 0.9),
        "unique_lr": True,
        "appearance_codes_lr_mul": 1.0,
        "mapping_net_lr_mul": 0.05,
        "neural_field_lr_mul": 0.05,
        "weight_decay": 0,
        "gan_lambda": 0,
        "photometric_lambda": 0,
        "perceptual_lambda": [0, 0, 0, 0],
        "latent_lambda": 0,
        "z_lambda": 0,
        "pos_lambda": 0,
        "semantic_lambda": 0,
        "segmentation_lambda": 1,
        "input_dim": 3,
        "output_dim": 3,
        "semantic_dim": 0,
        "geo_feature_dim": 31,
        "label_dim": 26,
        "grad_clip": 1.0,
        "neural_field_cls": "COORDCONCATSIREN",
        "generator": "Map3DGenerator",
        "neural_field_blocks": 4,
        "synthesis_blocks": 9,
        "mod_blocks": list(range(3)),
        "spatial_normalization": "batch_norm",
        "discriminator": "UNetDiscriminator",
        "condition_modal_disc_real": "body_segments",
        "condition_modal_disc_gen": "rasterized_segments",
        "condition_modal_gen": "rasterized_segments",
        "ada_aug": dict(
            xflip=1,
            rotate90=0,
            rotate_max=0.05,
            xint=0,
            scale=1,
            rotate=1,
            aniso=1,
            xfrac=0,
            brightness=1,
            contrast=1,
            saturation=1,
        ),
        "ada_target": 0.6,
        "ada_interval": 0,
        "ada_kimg": 20,
        "ada_alpha_thresh": 0.5,
        "dataset": "SHHQDataset",
        "joints": list(range(24)),
        "white_back": True,
        "clamp_mode": "relu",
        "z_dist": "gaussian",
        "hierarchical_sample": False,
        "learnable_dist": False,
        "last_back": False,
        "eval_last_back": True,
    }


MAP3DBN = {
    0: {"batch_size": 32, "batch_split": 1, "gen_lr": 1e-4, "disc_lr": 4e-4},
    int(140e3 + 1): {"batch_size": 32, "batch_split": 1, "gen_lr": 5e-5, "disc_lr": 2e-4},
    int(300e3 + 1): {},
    "name": "map3dbn",
    "render_width": 32,
    "render_height": 64,
    "gen_width": 128,
    "gen_height": 256,
    "r1_lambda": 0.25,
    "latent_dim": 384,
    "hidden_dim": 384,
    "feature_dim": 384,
    "map3d_mode": "mixed",
    "dataset_length": 10,
    "dataroot": "./datasets/shhq_example_dataset",
    # no synthesis rematerialization (the JAX package's choice for this
    # config; the port ignores the flag)
    "remat_synthesis": False,
    **_common(),
}

MAP3DBN512 = {
    0: {"batch_size": 32, "batch_split": 1, "gen_lr": 5e-5, "disc_lr": 2e-4},
    int(300e3 + 1): {},
    "name": "map3dbn512",
    "render_width": 48,
    "render_height": 96,
    "gen_width": 256,
    "gen_height": 512,
    "r1_lambda": 0,
    "latent_dim": 256,
    "hidden_dim": 256,
    "feature_dim": 256,
    "map3d_mode": "mixed",
    "dataset_length": 10,
    "dataroot": "./datasets/shhq_example_dataset",
    **_common(),
}

# Legacy variant matching the released checkpoint (map3dbn512l @ step 295k).
MAP3DBN512L = {
    0: {"batch_size": 32, "batch_split": 1, "gen_lr": 5e-5, "disc_lr": 2e-4},
    int(300e3 + 1): {},
    "name": "map3dbn512l",
    "legacy_mode": True,
    "render_width": 48,
    "render_height": 96,
    "gen_width": 256,
    "gen_height": 512,
    "r1_lambda": 0,
    "latent_dim": 420,
    "hidden_dim": 420,
    "feature_dim": 420,
    "map3d_mode": "isolated",
    "dataset_length": 219047,
    "dataroot": "./datasets/shhq_train_40000",
    **_common(),
}

# Small config for tests / smoke runs (not in the reference; TPU-build extra).
MAP3DBN_TINY = {
    0: {"batch_size": 2, "batch_split": 1, "gen_lr": 1e-4, "disc_lr": 4e-4},
    int(1e3 + 1): {},
    "name": "map3dbn_tiny",
    "render_width": 8,
    "render_height": 16,
    "gen_width": 32,
    "gen_height": 64,
    "r1_lambda": 0.25,
    "latent_dim": 32,
    "hidden_dim": 32,
    "feature_dim": 32,
    "map3d_mode": "mixed",
    "dataset_length": 4,
    "dataroot": "synthetic",
    **_common(),
}
MAP3DBN_TINY["num_steps"] = 8
MAP3DBN_TINY["use_mixed_precision"] = False

# Smallest-possible config that still exercises every subsystem (rasterize,
# field, SPADE synthesis w/ skip+ToRGB structure, U-Net D, R1, optimizer):
# used by the multi-chip sharding dryrun and trainer smoke tests, where XLA
# compile time — not model quality — is the binding constraint.
MAP3DBN_NANO = {
    0: {"batch_size": 2, "batch_split": 1, "gen_lr": 1e-4, "disc_lr": 4e-4},
    int(1e3 + 1): {},
    "name": "map3dbn_nano",
    "render_width": 4,
    "render_height": 8,
    "gen_width": 8,
    "gen_height": 16,
    "r1_lambda": 0.25,
    "latent_dim": 16,
    "hidden_dim": 16,
    "feature_dim": 16,
    "map3d_mode": "mixed",
    "dataset_length": 8,
    "dataroot": "synthetic",
    **_common(),
}
MAP3DBN_NANO["num_steps"] = 4
MAP3DBN_NANO["use_mixed_precision"] = False
MAP3DBN_NANO["synthesis_blocks"] = 3
MAP3DBN_NANO["mod_blocks"] = [0]
MAP3DBN_NANO["neural_field_blocks"] = 2
