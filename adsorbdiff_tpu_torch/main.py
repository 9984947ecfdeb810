"""Command line: train or validate on the CUDA card (``--cpu``: on the host).

    python -m adsorbdiff_tpu_torch.main --mode train \
        --config-yml configs/denoising/painn_so3.yml --dataset.0.src=train.adshard.npz [--cpu]

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
