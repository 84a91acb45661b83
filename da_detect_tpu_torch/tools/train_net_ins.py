"""Instance-level-only DA ablation (port of
``da_detect_tpu/tools/train_net_ins.py``; reference tools/train_net-ins.py):
``train_net`` with the image and consistency DA losses weighted 0.

    python -m da_detect_tpu_torch.tools.train_net_ins --config-file <yaml> \
        [--device cpu] [KEY VALUE ...]
"""

from __future__ import annotations

from .common import ablation_main


def main(argv=None):
    return ablation_main(
        argv, "DA ablation: instance-level alignment only (PyTorch port)",
        ("MODEL.DA_HEADS.DA_IMG_LOSS_WEIGHT",
         "MODEL.DA_HEADS.DA_CST_LOSS_WEIGHT"),
        "da_detect_tpu_torch.train_ins")


if __name__ == "__main__":
    main()
