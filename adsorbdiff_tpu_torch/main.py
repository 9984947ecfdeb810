"""Command line: train, validate, predict or run relaxations on the CUDA card
(``--cpu``: on the host).

    python -m adsorbdiff_tpu_torch.main --mode train \
        --config-yml configs/denoising/painn_so3.yml --dataset.0.src=train.adshard.npz [--cpu]
    python -m adsorbdiff_tpu_torch.main --mode run-relaxations \
        --config-yml configs/denoising/gemnet_so3.yml --checkpoint checkpoints/run/checkpoint \
        --task.relax_dataset.src=relax.adshard.npz --task.write_pos=True [--cpu]

``predict`` writes the EMA model's scores over the validation set (else the
relax set) to ``results/<identifier>/predictions.npz``; ``run-relaxations``
samples ``task.relax_dataset`` by reverse diffusion from a checkpoint.

Dotted overrides (``--optim.batch_size=8``) merge into the config; a list
entry is named by its index (``--dataset.0.src=...``).  Sweeps and cluster
submission are not ported.
"""
from __future__ import annotations

from adsorbdiff_tpu_torch.common.config import build_config
from adsorbdiff_tpu_torch.common.flags import get_parser
from adsorbdiff_tpu_torch.common.logging_utils import setup_logging
from adsorbdiff_tpu_torch.tasks import new_trainer_context


def main(argv=None) -> None:
    setup_logging()
    args, override_args = get_parser().parse_known_args(argv)
    config = build_config(args, override_args)
    with new_trainer_context(config) as ctx:
        ctx.task.run()


if __name__ == "__main__":
    main()
