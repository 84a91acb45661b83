"""Dataset / model catalogs.

Equivalent of the reference's ``config/paths_catalog.py`` (DatasetCatalog:7,
ModelCatalog:254), with the hard-coded author paths replaced by a relative
layout under ``$DA_DETECT_DATA_DIR`` (default ``./datasets``) — SURVEY §7.4
flags the absolute paths as a defect not to replicate.
"""

from __future__ import annotations

import os


def data_dir() -> str:
    return os.environ.get("DA_DETECT_DATA_DIR", "datasets")


_CITY_ANN = "cityscapes/annotations"


class DatasetCatalog:
    """name -> factory + constructor args (paths relative to data_dir())."""

    DATASETS = {
        # COCO
        "coco_2017_train": ("coco/train2017", "coco/annotations/instances_train2017.json"),
        "coco_2017_val": ("coco/val2017", "coco/annotations/instances_val2017.json"),
        "coco_2014_train": ("coco/train2014", "coco/annotations/instances_train2014.json"),
        "coco_2014_val": ("coco/val2014", "coco/annotations/instances_val2014.json"),
        "coco_2014_minival": ("coco/val2014", "coco/annotations/instances_minival2014.json"),
        "coco_2014_valminusminival": (
            "coco/val2014", "coco/annotations/instances_valminusminival2014.json"),
        "keypoints_coco_2014_train": (
            "coco/train2014", "coco/annotations/person_keypoints_train2014.json"),
        "keypoints_coco_2014_val": (
            "coco/val2014", "coco/annotations/person_keypoints_val2014.json"),
        "keypoints_coco_2014_minival": (
            "coco/val2014", "coco/annotations/person_keypoints_minival2014.json"),
        "keypoints_coco_2014_valminusminival": (
            "coco/val2014", "coco/annotations/person_keypoints_valminusminival2014.json"),
        # Cityscapes (coco-style conversions; see tools/cityscapes converters)
        "cityscapes_fine_instanceonly_seg_train_cocostyle": (
            "cityscapes/leftImg8bit/train", f"{_CITY_ANN}/instancesonly_filtered_gtFine_train.json"),
        "cityscapes_fine_instanceonly_seg_val_cocostyle": (
            "cityscapes/leftImg8bit/val", f"{_CITY_ANN}/instancesonly_filtered_gtFine_val.json"),
        "cityscapes_fine_instanceonly_seg_test_cocostyle": (
            "cityscapes/leftImg8bit/test", f"{_CITY_ANN}/instancesonly_filtered_gtFine_test.json"),
        "foggy_cityscapes_fine_instanceonly_seg_train_cocostyle": (
            "foggy_cityscapes/leftImg8bit_foggy/train",
            f"{_CITY_ANN}/instancesonly_filtered_gtFine_train.json"),
        "foggy_cityscapes_fine_instanceonly_seg_val_cocostyle": (
            "foggy_cityscapes/leftImg8bit_foggy/val",
            f"{_CITY_ANN}/instancesonly_filtered_gtFine_val.json"),
        # Rainy Cityscapes: pixel-aligned rain renderings of the same images,
        # reusing the clean annotations (the aux/negative domain).
        "rainy_cityscapes_fine_instanceonly_seg_train_cocostyle": (
            "rainy_cityscapes/leftImg8bit_rain/train",
            f"{_CITY_ANN}/instancesonly_filtered_gtFine_train.json"),
        "rainy_cityscapes_fine_instanceonly_seg_val_cocostyle": (
            "rainy_cityscapes/leftImg8bit_rain/val",
            f"{_CITY_ANN}/instancesonly_filtered_gtFine_val.json"),
        # BDD100k
        "bdd100k_daytime_clear_city_street_train_cocostyle": (
            "bdd100k/daytime_clear_city_street_coco/train",
            "bdd100k/daytime_clear_city_street_coco/train_bdd100k_coco.json"),
        "rainy_bdd100k_daytime_clear_city_street_train_cocostyle": (
            "bdd100k/overcast",
            "bdd100k/daytime_clear_city_street_coco/train_bdd100k_coco.json"),
        "bdd100k_daytime_clear_city_street_val_cocostyle": (
            "bdd100k/daytime_clear_city_street_coco/val",
            "bdd100k/daytime_clear_city_street_coco/val_bdd100k_coco.json"),
        # Sim10k / KITTI / car-only Cityscapes
        "sim10k_cocostyle": ("sim10k/JPEGImages", "sim10k/car_instances.json"),
        "kitti_cocostyle": ("kitti/training/image_2", "kitti/caronly_training.json"),
        "cityscapes_car_train_cocostyle": (
            "cityscapes/leftImg8bit/train", f"{_CITY_ANN}/caronly_filtered_gtFine_train.json"),
        "cityscapes_rain_car_trian_cocostyle": (  # (sic) name kept for config compat
            "rainy_cityscapes/leftImg8bit_rain/train",
            f"{_CITY_ANN}/caronly_filtered_gtFine_train.json"),
        "cityscapes_car_val_cocostyle": (
            "cityscapes/leftImg8bit/val", f"{_CITY_ANN}/caronly_filtered_gtFine_val.json"),
        # VOC coco-style
        "voc_2007_train_cocostyle": (
            "voc/VOC2007/JPEGImages", "voc/VOC2007/Annotations/pascal_train2007.json"),
        "voc_2007_val_cocostyle": (
            "voc/VOC2007/JPEGImages", "voc/VOC2007/Annotations/pascal_val2007.json"),
        "voc_2007_test_cocostyle": (
            "voc/VOC2007/JPEGImages", "voc/VOC2007/Annotations/pascal_test2007.json"),
        "voc_2012_train_cocostyle": (
            "voc/VOC2012/JPEGImages", "voc/VOC2012/Annotations/pascal_train2012.json"),
        "voc_2012_val_cocostyle": (
            "voc/VOC2012/JPEGImages", "voc/VOC2012/Annotations/pascal_val2012.json"),
        # Artistic-domain sets
        "clipart_cocostyle": ("clipart/JPEGImages", "clipart/instances.json"),
        "watercolor_train_cocostyle": ("watercolor/JPEGImages", "watercolor/instances_train.json"),
        "watercolor_val_cocostyle": ("watercolor/JPEGImages", "watercolor/instances_test.json"),
    }

    # native VOC-xml splits
    VOC_DATASETS = {
        "voc_2007_train": ("voc/VOC2007", "train"),
        "voc_2007_val": ("voc/VOC2007", "val"),
        "voc_2007_test": ("voc/VOC2007", "test"),
        "voc_2012_train": ("voc/VOC2012", "train"),
        "voc_2012_val": ("voc/VOC2012", "val"),
    }

    @staticmethod
    def get(name: str) -> dict:
        root = data_dir()
        # user-extensible entries: $DA_DETECT_DATA_DIR/catalog.json maps
        # extra dataset names -> {img_dir, ann_file[, factory]} (the
        # reference requires editing paths_catalog.py for new datasets)
        custom_path = os.path.join(root, "catalog.json")
        if os.path.exists(custom_path):
            import json
            with open(custom_path) as f:
                custom = json.load(f)
            if name in custom:
                e = custom[name]
                return {"factory": e.get("factory", "COCODataset"),
                        "args": {"root": os.path.join(root, e["img_dir"]),
                                 "ann_file": os.path.join(root, e["ann_file"])}}
        if name in DatasetCatalog.VOC_DATASETS:
            d, split = DatasetCatalog.VOC_DATASETS[name]
            return {"factory": "PascalVOCDataset",
                    "args": {"data_dir": os.path.join(root, d), "split": split}}
        if name in DatasetCatalog.DATASETS:
            img_dir, ann_file = DatasetCatalog.DATASETS[name]
            return {"factory": "COCODataset",
                    "args": {"root": os.path.join(root, img_dir),
                             "ann_file": os.path.join(root, ann_file)}}
        raise RuntimeError(f"Dataset not available: {name}")


def load_user_catalog(path: str) -> None:
    """Import a user paths-catalog module (the reference's PATHS_CATALOG /
    utils/imports.py mechanism): any module defining a ``DatasetCatalog``
    class with ``get(name)`` overrides the built-in one."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("user_paths_catalog", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    if hasattr(module, "DatasetCatalog"):
        DatasetCatalog.get = staticmethod(module.DatasetCatalog.get)


class ModelCatalog:
    """Resolve ``catalog://`` model identifiers to local/cached weight files.

    Unlike the reference (which downloads from the Detectron S3 bucket at
    run time, config/paths_catalog.py:254-312), weights must be present under
    ``$DA_DETECT_WEIGHTS_DIR`` (default ``./weights``); zero-egress TPU pods
    should not fetch at train time.
    """

    C2_IMAGENET_MODELS = {
        "MSRA/R-50": "R-50.pkl",
        "MSRA/R-50-GN": "R-50-GN.pkl",
        "MSRA/R-101": "R-101.pkl",
        "MSRA/R-101-GN": "R-101-GN.pkl",
        "FAIR/20171220/X-101-32x8d": "X-101-32x8d.pkl",
    }

    @staticmethod
    def weights_dir() -> str:
        return os.environ.get("DA_DETECT_WEIGHTS_DIR", "weights")

    @staticmethod
    def get(name: str) -> str:
        assert name.startswith("catalog://")
        key = name[len("catalog://"):]
        prefix = "ImageNetPretrained/"
        if key.startswith(prefix):
            rel = ModelCatalog.C2_IMAGENET_MODELS[key[len(prefix):]]
            return os.path.join(ModelCatalog.weights_dir(), rel)
        # fall through: treat remainder as a relative path under weights_dir
        return os.path.join(ModelCatalog.weights_dir(), key)
