"""The training loop (threedhumangan_tpu/trainers/base_trainer.py).

``Trainer`` holds the port's ``TrainState`` on its device and runs:
  * the curriculum: ``extract_metadata`` per step; the loop stops at a block
    without ``batch_size``; a change of batch or resolution rebuilds the
    stage (dataset, preprocessor, micro-batching); the learning rates come
    through ``_cur_lr``;
  * the phase cycle ``phases[step % 8]``, nerf noise ``max(0, 1 - step/5000)``,
    one D step then one G step (``train_step_pair``);
  * ``pallas_synthesis_train`` on by default on CUDA (the JAX trainer turns
    it on on an accelerator), so the synthesis runs on K10/K11;
  * metrics: every step's moments summed on the device, pulled every 10
    steps into a ``Collector``; the windowed ``imgs_per_sec`` and the
    cumulative ``imgs_per_sec_cum``; the stage's ``batch_split`` and
    ``remat_synthesis`` (0/1) and the run's ``oom_retries``; ``metrics.jsonl``
    plus TensorBoard;
  * spans (``utils.trace``): ``trainer.pair`` around each iteration of the
    loop (the batch's wait included; a unit's root), ``trainer.step``
    around the pair with its out-of-memory retries, ``trainer.stats_pull``
    around each pull and log;
  * checkpoints every ``model_save_interval`` steps, written on a background
    thread after a synchronous copy to the host, pruned to
    ``model_keep_interval``; resume from the latest.  The checkpoint also
    holds the random generator's state, and a resumed run starts at the
    batch where the saved one stopped, so a resumed run repeats the steps of
    an uninterrupted one exactly;
  * EMA sample grids (``log_image``, PNG) and weight histograms
    (``log_weights``) every ``sample_interval`` steps;
  * synthesis remat (``remat_synthesis``) by ``auto_remat_synthesis`` for
    one device micro-batch, batch // world_size // batch_split, unless the
    config pins it, with the fused synthesis on; ``opt.bs_factor``
    multiplies the config's ``batch_split``;
  * out-of-memory recovery on ``torch.cuda.OutOfMemoryError``: double
    ``batch_split``, rebuild the stage (which decides remat again) and retry
    the step when no optimizer has stepped in it, else restore the latest
    checkpoint (``self.step`` set before the stage rebuild).  A stage's
    first pair keeps a host copy of the discriminator and its optimizer, so
    running out of memory in that pair's G step undoes its D step and
    retries too.  Buffers a failed forward already advanced (BN running
    stats, spectral-norm ``u``) stay advanced on a retry.

Data parallelism, one process a device (as the original repo's DDP over
NCCL; the JAX package's mesh step): the caller initialises the default
process group (``apps/train.py``) and passes its ``rank`` and
``world_size``; the trainer never picks a backend, and without a group it
issues no collective.  Across ranks:
  * the global ``batch_size`` is split: rank r takes ``batch_size //
    world_size`` items, every ``world_size``-th of the seeded shuffle from
    r, and an epoch has the batches that every rank has;
  * the weights are built from the seed alone on every rank, then held
    once: one all-reduce of a checksum of G, D and the EMA raises if the
    ranks differ (``parallel.dist.check_replicas``);
  * each rank draws from its own generator: rank 0's is seeded with the
    seed (a one-process run is unchanged), rank r's with a seed derived
    from (seed, r) (JAX's ``fold_in(rng, axis_index)``);
  * the sync-BN moments and the gradients are reduced across ranks inside
    the steps (``trainers/phase_trainer.py``); the summed statistics once
    at each pull, in one collective (``parallel.stats.psum_moments``);
  * rank 0 alone writes ``options.txt``, ``metrics.jsonl``, TensorBoard
    events, sample grids, weight histograms and checkpoints (the samples
    run in eval mode and make no collective, so no rank waits on them);
    a checkpoint holds every rank's generator state, gathered before the
    write, and every rank resumes from it with its own; the run ends with
    the last write joined and a barrier, so no rank reads a checkpoint
    before it is whole.
Out of device memory at world size 2 or more, the rank raises a
``RuntimeError`` that names it and ``--bs_factor``, and ends; the other
ranks then fail in their next collective (at once under gloo, at the
group's timeout under NCCL).  No rank recovers alone: the sync-BN
all-reduces sit inside the forward, so a rank that retried would leave the
others waiting in a collective it never reaches, or step with weights they
do not have.

ADA (``ada_interval > 0``): the trainer holds the augmentation
probability ``ada_p``, hands it to every pair, and after each pair that
succeeded on a step that ``ada_interval`` divides runs the JAX package's
controller (``update_augment``) on that step's ``real_signs``, summed over
ranks first in one collective, so every rank holds the same p.  The
controller reads the moments on the host: one sync every ``ada_interval``
steps.  ``real_signs`` exists only with ``gan_lambda > 0``; without it p
stays where it is, as in the JAX trainer.  ``ada_p`` is saved in the
checkpoint and restored on resume (a checkpoint without it restores 0);
the JAX trainer does not save it and restarts p at 0.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from threedhumangan_tpu_torch import configs
from threedhumangan_tpu_torch.data.dataset import (
    batches_per_rank,
    get_dataset_distributed,
    to_tensors,
)
from threedhumangan_tpu_torch.data.prefetch import prefetch
from threedhumangan_tpu_torch.data.preprocessor import get_preprocessor
from threedhumangan_tpu_torch.models.generator import auto_remat_synthesis
from threedhumangan_tpu_torch.parallel import dist
from threedhumangan_tpu_torch.parallel.stats import Collector, psum_moments
from threedhumangan_tpu_torch.trainers.phase_trainer import TrainState, init_train_state
from threedhumangan_tpu_torch.trainers import phase_trainer
from threedhumangan_tpu_torch.utils.checkpoint import (
    latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
    to_host,
)
from threedhumangan_tpu_torch.utils import trace
from threedhumangan_tpu_torch.utils.misc import resolve_device


def _opt_steps(opt: torch.optim.Optimizer) -> float:
    """Updates the optimizer has made (its first parameter's Adam step count)."""
    return float(next(iter(opt.state.values()))["step"]) if opt.state else 0.0


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s generator: ``seed`` on rank 0, else a
    32-bit seed derived from (seed, rank)."""
    if rank == 0:
        return seed
    return int(np.random.SeedSequence((seed, rank)).generate_state(1)[0])


@contextlib.contextmanager
def _ema_weights(G: torch.nn.Module, ema: Dict):
    """Run with the EMA parameters in ``G``, then put the trained ones back."""
    params = dict(G.named_parameters())
    saved = {k: p.detach().clone() for k, p in params.items()}
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(ema["params"][k])
    try:
        yield
    finally:
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(saved[k])


class Trainer:
    """Trainer of rank ``rank`` of ``world_size`` (module docstring); ``opt``
    carries the CLI options of apps/train.py."""

    def __init__(self, rank: int, world_size: int, opt, config: Dict, smpl_model=None):
        if (rank, world_size) != (dist.rank(), dist.world_size()):
            raise ValueError(f"Trainer(rank={rank}, world_size={world_size}) needs a process "
                             f"group of that size: the default group has rank {dist.rank()} "
                             f"of {dist.world_size()}")
        self.rank, self.world_size = rank, world_size
        self.opt = opt
        self.config = config
        self.device = resolve_device(getattr(opt, "device", "cuda"))
        self.output_dir = os.path.join(opt.output_dir, config["name"])
        os.makedirs(self.output_dir, exist_ok=True)
        self.meta = configs.extract_metadata(config, 0)
        self.ada_p = 0.0
        self.smpl_model = smpl_model
        self.tb = None
        if rank == 0 and getattr(opt, "tensorboard", 1):
            from threedhumangan_tpu_torch.utils.tb import EventWriter

            self.tb = EventWriter(self.output_dir)
        self.collector = Collector(".*")
        self._stats_acc: Optional[Dict[str, torch.Tensor]] = None
        self._save_thread: Optional[threading.Thread] = None
        self._saved_step: Optional[int] = None
        self._batch_split_min = 1
        self._oom_retries = 0  # out-of-memory recoveries of the run so far
        self._stage_token = 0
        self.batch_size = self.proc_batch_size = self.gen_height = self.gen_width = None
        self.step = 0

        seed = getattr(opt, "seed", 0)
        self.generator = torch.Generator(device=self.device).manual_seed(rank_seed(seed, rank))
        # the weights from the seed alone: the same on every rank
        self.ts: TrainState = init_train_state(self.meta, torch.Generator().manual_seed(seed),
                                               self.device)
        ckpt = latest_checkpoint(self.output_dir)
        payload = load_checkpoint(ckpt) if ckpt else None
        if payload is not None:
            self.step = int(payload["step"])  # before the stage is built for it
        self._build_stage(configs.extract_metadata(config, self.step))
        if payload is not None:
            self._load_state(payload)
            print(f"rank {rank}: resumed from {ckpt} at step {self.step}", flush=True)
        else:  # the latent pool starts at the dataset's latents
            latents = torch.as_tensor(self.dataset.get_all_latents())
            with torch.no_grad():
                self.ts.G.latent_pool.latents.copy_(latents)
        dist.check_replicas(self._replica_tensors(), self.device)

    def _replica_tensors(self) -> Dict[str, torch.Tensor]:
        """What every rank must hold alike: G's and D's parameters and
        buffers, and the EMA."""
        ts = self.ts
        out = {f"G.{k}": v for k, v in ts.G.state_dict().items()}
        out.update({f"D.{k}": v for k, v in ts.D.state_dict().items()})
        out.update({f"ema.{k}": v for k, v in ts.ema["params"].items()})
        return out

    # -- stage management -----------------------------------------------------

    def _build_stage(self, meta: Dict):
        """Rebuild the dataset, preprocessor and micro-batching for a stage."""
        self._stage_token += 1
        self._stage_fits = False  # no pair of this stage has completed yet
        self.batch_size = meta["batch_size"]
        if self.batch_size % self.world_size:
            raise ValueError(f"batch_size {self.batch_size} does not split over "
                             f"{self.world_size} ranks")
        self.proc_batch_size = self.batch_size // self.world_size
        self.gen_height, self.gen_width = meta["gen_height"], meta["gen_width"]
        reserved = ("smpl_model", "batch_size", "name", "dataset", "world_size", "rank")
        kwargs = {k: v for k, v in meta.items() if k not in reserved}
        self.loader_fn, self.dataset = get_dataset_distributed(
            meta["dataset"], self.world_size, self.rank, self.proc_batch_size,
            smpl_model=self.smpl_model, **kwargs)
        root = getattr(self.dataset, "root", None)
        print(f"rank {self.rank}: dataset {type(self.dataset).__name__}, {len(self.dataset)} "
              f"items" + (f" under {root}" if root else ""), flush=True)
        self._stage_meta = dict(meta)
        for k in ("nerf_noise", "gen_lr", "disc_lr"):
            self._stage_meta.pop(k, None)
        self._stage_meta["batch_split"] = max(
            int(meta.get("batch_split", 1)) * int(getattr(self.opt, "bs_factor", 1)),
            self._batch_split_min)
        self._cur_lr = (meta.get("gen_lr", 0.0), meta.get("disc_lr", 0.0))
        # the fused train synthesis (K10/K11) serves the D-step fakes and the
        # G step on the card
        self._stage_meta.setdefault("pallas_synthesis_train", self.device.type == "cuda")
        # synthesis remat unless the config pins it: decided for one device
        # micro-batch, so again after an out-of-memory error doubles the split
        if self._stage_meta["pallas_synthesis_train"]:
            micro = max(1, self.proc_batch_size // self._stage_meta["batch_split"])
            self._stage_meta.setdefault("remat_synthesis",
                                        auto_remat_synthesis(self._stage_meta, micro))
        self.preprocessor = get_preprocessor(self._stage_meta, self.dataset.smpl_model)

    def _meta_for_step(self, step: int) -> Optional[Dict]:
        meta = configs.extract_metadata(self.config, step)
        if "batch_size" not in meta:
            return None
        if (meta["batch_size"] != self.batch_size or meta["gen_height"] != self.gen_height
                or meta["gen_width"] != self.gen_width):
            self._build_stage(meta)
        self._cur_lr = (meta["gen_lr"], meta["disc_lr"])
        return self._stage_meta

    # -- state ----------------------------------------------------------------

    def _rng_states(self):
        """Every rank's generator state, by rank (a collective)."""
        state = self.generator.get_state()
        return [s.cpu() for s in dist.all_gather(state.to(self.device))]

    def _payload(self, rngs) -> Dict:
        ts = self.ts
        return {"G": ts.G.state_dict(), "D": ts.D.state_dict(),
                "opt_G": ts.opt_G.state_dict(), "opt_D": ts.opt_D.state_dict(),
                "ema": {"params": ts.ema["params"], "count": ts.ema["count"]},
                "rng": rngs, "ada_p": self.ada_p, "config_name": self.config["name"]}

    def _load_state(self, payload: Dict):
        ts, dev = self.ts, self.device
        ts.G.load_state_dict(payload["G"])
        ts.D.load_state_dict(payload["D"])
        ts.opt_G.load_state_dict(payload["opt_G"])
        ts.opt_D.load_state_dict(payload["opt_D"])
        ts.ema = {"params": {k: v.to(dev) for k, v in payload["ema"]["params"].items()},
                  "count": int(payload["ema"]["count"])}
        rngs = payload["rng"]
        rngs = rngs if isinstance(rngs, list) else [rngs]  # saved by one process
        if self.rank < len(rngs):
            self.generator.set_state(rngs[self.rank])
        else:
            print(f"rank {self.rank}: the checkpoint holds {len(rngs)} ranks' random states; "
                  "this rank keeps its fresh one", flush=True)
        self.ada_p = float(payload.get("ada_p", 0.0))
        self.step = ts.step = int(payload["step"])

    def update_augment(self, meta: Dict, stats: Dict[str, torch.Tensor]) -> None:
        """The ADA controller: p moves by sign(E[sign(D(real))] - ada_target)
        * ada_interval * batch_size / (ada_kimg * 1000), clipped to [0, 1]."""
        if "real_signs" not in stats:
            return
        count, total = psum_moments({"real_signs": stats["real_signs"]})["real_signs"][:2].tolist()
        delta = meta["ada_interval"] * meta["batch_size"] / (meta["ada_kimg"] * 1000)
        signs = np.float64(total) / np.float64(count)
        self.ada_p = float(np.clip(self.ada_p + np.sign(signs - meta["ada_target"]) * delta,
                                   0.0, 1.0))

    def save(self):
        """Checkpoint, on every rank: the ranks' generator states are
        gathered, then rank 0 copies the payload to the host synchronously
        (the next step updates the tensors in place) and writes the npz and
        prunes on a background thread.  Writes are serialised."""
        self._join_save()
        self._saved_step = self.step
        rngs = self._rng_states()
        if self.rank != 0:
            return
        payload = to_host(self._payload(rngs))
        keep = getattr(self.opt, "model_keep_interval", 5000)
        self._save_thread = threading.Thread(
            target=save_checkpoint, args=(self.output_dir, self.step, payload),
            kwargs={"keep_interval": keep}, daemon=True)
        self._save_thread.start()

    def _join_save(self):
        if self._save_thread is not None:
            self._save_thread.join()
            self._save_thread = None

    # -- out-of-memory recovery ---------------------------------------------------

    def _try_oom_recovery(self, untouched: bool) -> Optional[str]:
        """After ``torch.cuda.OutOfMemoryError`` in a step: double batch_split
        and rebuild the stage.  Returns "retry" when no optimizer stepped in
        the failed step (``untouched``), "restored" after loading the latest
        checkpoint otherwise, None when it cannot recover."""
        self._join_save()  # a checkpoint still being written counts
        cur = int(self._stage_meta.get("batch_split", 1))
        new = cur * 2
        if self.batch_size % new:
            return None
        if not untouched and not latest_checkpoint(self.output_dir):
            return None
        self._batch_split_min = new
        self._oom_retries += 1
        print(f"rank {self.rank}: train step ran out of device memory; batch_split {cur} -> "
              f"{new}", flush=True)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        if untouched:
            self._build_stage(configs.extract_metadata(self.config, self.step))
            return "retry"
        ckpt = latest_checkpoint(self.output_dir)
        payload = load_checkpoint(ckpt)
        self.step = int(payload["step"])
        self._build_stage(configs.extract_metadata(self.config, self.step))
        self._load_state(payload)
        print(f"rank {self.rank}: the failed step had updated weights; restored {ckpt} at "
              f"step {self.step}", flush=True)
        return "restored"

    # -- logging ------------------------------------------------------------------

    def write_options(self):
        if self.rank != 0:
            return
        n_g = sum(p.numel() for p in self.ts.G.parameters())
        n_d = sum(p.numel() for p in self.ts.D.parameters())
        with open(os.path.join(self.output_dir, "options.txt"), "w") as f:
            f.write(str(vars(self.opt) if hasattr(self.opt, "__dict__") else self.opt))
            f.write(f"\n\ngenerator: {n_g:,} params\ndiscriminator: {n_d:,} params\n\n\n")
            f.write(repr({k: v for k, v in self.config.items() if isinstance(k, str)}))

    def _log(self, scalars: Dict[str, float]):
        if self.rank != 0:
            return
        with open(os.path.join(self.output_dir, "metrics.jsonl"), "a") as f:
            f.write(json.dumps({"step": self.step, **scalars}) + "\n")
        if self.tb is not None:
            for name, value in scalars.items():
                self.tb.add_scalar(f"train/{name}", value, self.step)
            self.tb.flush()

    @torch.no_grad()
    def log_image(self, meta: Dict) -> None:
        """EMA sample grids (fixed and tilted camera) and the discriminator's
        segmentation of them, as PNGs in the output directory."""
        from threedhumangan_tpu_torch.data.utils import colorize_labels, make_grid, write_png
        from threedhumangan_tpu_torch.models.generator import staged_forward

        n = min(4, self.proc_batch_size)
        data = next(iter(self.loader_fn(seed=123, shuffle=False)))
        batch = to_tensors({k: v[:n] for k, v in data.items()}, self.device)
        eval_meta = dict(self._stage_meta, nerf_noise=0, perturb_rays=False, h_stddev=0,
                         v_stddev=0)
        gen = torch.Generator(device=self.device).manual_seed(self.step)
        z = torch.randn(n, eval_meta["latent_dim"], generator=gen, device=self.device)
        cdt = phase_trainer.compute_dtype(eval_meta)
        zeros = torch.zeros(n, device=self.device)
        for tag, h_mean in (("fixed", 0.0), ("tilted", float(meta.get("vis_rotate", 0.5)))):
            cond = self.preprocessor.forward_with_rotation(batch, zeros + h_mean, zeros, zeros)
            with _ema_weights(self.ts.G, self.ts.ema):
                out = staged_forward(self.ts.G, z, cond, eval_meta, gen, truncation_psi=0.7,
                                     compute_dtype=cdt)
            imgs = (out["rgbs"].float() * 0.5 + 0.5).clamp(0, 1).cpu().numpy()
            write_png(os.path.join(self.output_dir, f"{self.step:08d}_{tag}_ema.png"),
                      make_grid(imgs, nrow=2))
            seg = self.ts.D(out["rgbs"], cdt, train=False)["segments"].argmax(-1)
            if seg.shape[1:3] != imgs.shape[1:3]:
                seg = torch.nn.functional.interpolate(seg[:, None].float(), size=imgs.shape[1:3],
                                                      mode="nearest")[:, 0].long()
            seg_rgb = colorize_labels(seg.cpu().numpy(), eval_meta["label_dim"])
            write_png(os.path.join(self.output_dir, f"{self.step:08d}_{tag}_dseg.png"),
                      make_grid(seg_rgb, nrow=2))

    def log_weights(self):
        """Per-parameter weight histograms (rank 0 alone has ``tb``)."""
        if self.tb is None:
            return
        for prefix, module in (("train/weights/gen", self.ts.G), ("train/weights/disc", self.ts.D)):
            for name, p in module.named_parameters():
                self.tb.add_histogram(f"{prefix}/{name.replace('.', '/')}",
                                      p.detach().float().cpu().numpy(), self.step)
        self.tb.flush()

    # -- main loop ----------------------------------------------------------------

    def run(self, max_steps: Optional[int] = None) -> None:
        try:
            self._run(max_steps)
        finally:
            self._join_save()  # the last background checkpoint write must land
        dist.barrier()  # and no rank goes on before it has

    def _train_step(self, batch, meta, phase, nerf_noise):
        """One D+G pair with out-of-memory recovery.  Returns the step's
        stats, or None when a checkpoint was restored (the caller restarts
        the data at the restored step)."""
        while True:
            before = (_opt_steps(self.ts.opt_D), _opt_steps(self.ts.opt_G))
            undo = None if self._stage_fits or self.world_size > 1 else self._d_on_host()
            try:
                self.ts, stats = phase_trainer.train_step_pair(
                    self.ts, batch, self.generator, meta, self.preprocessor, phase,
                    self._cur_lr[0], self._cur_lr[1], nerf_noise, ada_p=self.ada_p)
                self._stage_fits = True
                return stats
            except torch.cuda.OutOfMemoryError as e:
                if self.world_size > 1:
                    split = self._stage_meta.get("batch_split", 1)
                    msg = (f"rank {self.rank}: the train step at step {self.step} ran out of "
                           f"device memory at batch_split {split}; every rank stops (one "
                           f"rank cannot retry alone). Restart with a larger --bs_factor.")
                    print(msg, flush=True)
                    raise RuntimeError(msg) from e
                if undo is not None and before[1] == _opt_steps(self.ts.opt_G):
                    self.ts.D.load_state_dict(undo["D"])
                    self.ts.opt_D.load_state_dict(undo["opt_D"])
                untouched = before == (_opt_steps(self.ts.opt_D), _opt_steps(self.ts.opt_G))
                outcome = self._try_oom_recovery(untouched)
                if outcome is None:
                    raise
                if outcome == "restored":
                    return None
                meta = self._stage_meta  # retry the same batch, micro-batched

    def _pull_stats(self, t0: float, t_window: float, step_window: int, host_sec: float):
        """Pull the summed moments to the host and log them with the windowed
        throughput and the run's memory choices (``batch_split``,
        ``remat_synthesis``, ``oom_retries``).  Returns the next window's
        (start time, start step)."""
        summed = psum_moments(self._stats_acc)  # over ranks: one collective
        self._stats_acc = None
        self.collector.update({k: v.cpu() for k, v in summed.items()})
        # a zero count means no observation in the window
        scalars = {n: self.collector[n] for n in self.collector.names()
                   if self.collector.num(n) > 0}
        now = time.time()
        scalars["imgs_per_sec"] = ((self.step - step_window) * self.batch_size
                                   / max(now - t_window, 1e-9))
        scalars["imgs_per_sec_cum"] = self.step * self.batch_size / max(now - t0, 1e-9)
        if host_sec:
            scalars["host_io_sec"] = host_sec
        scalars["batch_split"] = int(self._stage_meta.get("batch_split", 1))
        scalars["remat_synthesis"] = int(bool(self._stage_meta.get("remat_synthesis", True)))
        scalars["oom_retries"] = self._oom_retries
        self._log(scalars)
        self.collector.reset()
        return now, self.step

    def _d_on_host(self) -> Dict:
        """A host copy of the discriminator's state and its optimizer's."""
        host = lambda t: t.detach().to("cpu", copy=True) if torch.is_tensor(t) else copy.copy(t)
        opt = self.ts.opt_D.state_dict()
        return {"D": {k: host(v) for k, v in self.ts.D.state_dict().items()},
                "opt_D": {"state": {i: {k: host(v) for k, v in st.items()}
                                    for i, st in opt["state"].items()},
                          "param_groups": copy.deepcopy(opt["param_groups"])}}

    def _run(self, max_steps: Optional[int] = None) -> None:
        n_epochs = getattr(self.opt, "n_epochs", 1)
        save_interval = getattr(self.opt, "model_save_interval", 1000)
        sample_interval = getattr(self.opt, "sample_interval", 0)
        self.write_options()
        t0 = time.time()
        t_window, step_window = t0, self.step  # windowed throughput: since the last log
        host_sec = 0.0                         # checkpoint/sample seconds in the window
        done = False
        while not done:
            meta = self._meta_for_step(self.step)
            if meta is None:
                break
            # the epoch and batch of this step: a resumed run continues where
            # the saved one stopped
            per_epoch = batches_per_rank(len(self.dataset), self.proc_batch_size,
                                         self.world_size)
            if per_epoch == 0:
                break
            epoch, start = divmod(self.step, per_epoch)
            if epoch >= n_epochs:
                break
            stage_token = self._stage_token
            batches = prefetch(self.loader_fn(seed=epoch, shuffle=True, start=start),
                               transform=lambda b: to_tensors(b, self.device))
            try:
                while True:
                    with trace.span("trainer.pair", unit=True):
                        batch = next(batches, None)
                        if batch is None:
                            break
                        meta = self._meta_for_step(self.step)
                        if meta is None or (max_steps is not None and self.step >= max_steps):
                            done = True
                            break
                        if self._stage_token != stage_token:
                            # curriculum boundary: the in-flight loader yields
                            # batches of the old shape; restart on the new one
                            self._stats_acc = None
                            break
                        phase = meta["phases"][self.step % len(meta["phases"])]
                        nerf_noise = max(0.0, 1.0 - self.step / 5000.0)
                        with trace.span("trainer.step"):
                            stats = self._train_step(batch, meta, phase, nerf_noise)
                        if stats is None:  # restored from a checkpoint: restart the data there
                            self._stats_acc = None
                            break
                        stage_token = self._stage_token  # a retry rebuilt the same-shape stage
                        self.step += 1
                        self.ts.step = self.step
                        if meta.get("ada_interval", 0) and self.step % meta["ada_interval"] == 0:
                            self.update_augment(meta, stats)

                        # every step's moments are summed on the device (no host
                        # sync), so phase-gated stats such as r1 (slots 3 and 7)
                        # are not lost between the pulls every 10 steps
                        if self._stats_acc is None:
                            self._stats_acc = dict(stats)
                        else:
                            for k, v in stats.items():
                                acc = self._stats_acc
                                acc[k] = v if k not in acc else acc[k] + v
                        if self.step % 10 == 0 or self.step == 1:
                            with trace.span("trainer.stats_pull"):
                                t_window, step_window = self._pull_stats(t0, t_window,
                                                                         step_window, host_sec)
                            host_sec = 0.0
                        if self.step % save_interval == 0:
                            t_io = time.time()
                            self.save()
                            host_sec += time.time() - t_io
                        if sample_interval and self.step % sample_interval == 0 and self.rank == 0:
                            t_io = time.time()
                            self.log_image(meta)
                            self.log_weights()
                            host_sec += time.time() - t_io
            finally:
                batches.close()
        if self._saved_step != self.step:
            self.save()


# registry for apps/train.py-style dispatch
TRAINERS = {"PhaseTrainer": Trainer, "BaseTrainer": Trainer}
