"""Data: datasets, transforms, the loaders, their transport to the device,
and evaluation (port of ``da_detect_tpu/data``)."""

from .build import (build_dataset, make_data_loader, make_data_loader_da,
                    prestage_datasets)

__all__ = ["build_dataset", "make_data_loader", "make_data_loader_da",
           "prestage_datasets"]
