"""Image-level-only DA ablation (port of
``da_detect_tpu/tools/train_net_img.py``; reference tools/train_net-img.py):
``train_net`` with the instance and consistency DA losses weighted 0.

    python -m da_detect_tpu_torch.tools.train_net_img --config-file <yaml> \
        [--device cpu] [KEY VALUE ...]
"""

from __future__ import annotations

from .common import ablation_main


def main(argv=None):
    return ablation_main(
        argv, "DA ablation: image-level alignment only (PyTorch port)",
        ("MODEL.DA_HEADS.DA_INS_LOSS_WEIGHT",
         "MODEL.DA_HEADS.DA_CST_LOSS_WEIGHT"),
        "da_detect_tpu_torch.train_img")


if __name__ == "__main__":
    main()
