# Mirrors yolo2_light_tpu/utils/voc_label.py: a copy, so that the port imports
# nothing of the JAX package.
"""VOC XML -> darknet txt label converter (training-data prep tool).

Same capability as the reference's bin/data/voc_label.py AND its
bin/data/voc_label_difficult.py variant: walks VOCdevkit image-set lists,
converts each Annotation XML into a ``class x y w h`` (relative,
center-format) label file, and writes per-set image list files.

``--difficult`` reproduces voc_label_difficult.py: the object filter
INVERTS (keep only difficult==1 boxes), and every artifact gains the
``difficult_`` prefix — the label file, the list file, and the ``.jpg``
paths inside it — which is what `detector map`'s images->labels /
.jpg->.txt path rewriting resolves when a `.data` file sets
``difficult = data/difficult_2007_test.txt`` (reference
additionally.c:4566-4570,4739-4747).

Usage:
    python -m yolo2_light_tpu_torch.utils.voc_label [--root VOCdevkit-parent] \
        [--sets 2007,train 2007,val ...] [--classes names...] [--difficult]
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET

VOC_CLASSES = ["aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car",
               "cat", "chair", "cow", "diningtable", "dog", "horse", "motorbike",
               "person", "pottedplant", "sheep", "sofa", "train", "tvmonitor"]

DEFAULT_SETS = [("2012", "train"), ("2012", "val"), ("2007", "train"),
                ("2007", "val"), ("2007", "test")]
# voc_label_difficult.py defaults to the eval-side sets only
DEFAULT_DIFFICULT_SETS = [("2012", "val"), ("2007", "test")]


def convert_box(size, box):
    """(xmin,xmax,ymin,ymax) pixels -> (x,y,w,h) relative center-format."""
    dw, dh = 1.0 / size[0], 1.0 / size[1]
    x = (box[0] + box[1]) / 2.0 * dw
    y = (box[2] + box[3]) / 2.0 * dh
    w = (box[1] - box[0]) * dw
    h = (box[3] - box[2]) * dh
    return x, y, w, h


def convert_annotation(root: str, year: str, image_id: str, classes,
                       difficult_only: bool = False) -> None:
    in_file = os.path.join(root, f"VOC{year}", "Annotations", f"{image_id}.xml")
    out_dir = os.path.join(root, f"VOC{year}", "labels")
    os.makedirs(out_dir, exist_ok=True)
    prefix = "difficult_" if difficult_only else ""
    tree = ET.parse(in_file)
    r = tree.getroot()
    size = r.find("size")
    w = int(size.find("width").text)
    h = int(size.find("height").text)
    with open(os.path.join(out_dir, f"{prefix}{image_id}.txt"), "w") as out:
        for obj in r.iter("object"):
            difficult = obj.find("difficult")
            dif = int(difficult.text) if difficult is not None else 0
            cls = obj.find("name").text
            if cls not in classes:
                continue
            # base tool drops difficult boxes; the difficult tool keeps ONLY them
            if (dif == 0) if difficult_only else (dif == 1):
                continue
            cls_id = classes.index(cls)
            b = obj.find("bndbox")
            box = (float(b.find("xmin").text), float(b.find("xmax").text),
                   float(b.find("ymin").text), float(b.find("ymax").text))
            bb = convert_box((w, h), box)
            out.write(f"{cls_id} " + " ".join(f"{v:.6f}" for v in bb) + "\n")


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--root", default="VOCdevkit")
    ap.add_argument("--sets", nargs="*", default=None,
                    help="year,set pairs e.g. 2007,train")
    ap.add_argument("--classes", nargs="*", default=VOC_CLASSES)
    ap.add_argument("--difficult", action="store_true",
                    help="emit ONLY difficult boxes with difficult_ prefixes "
                         "(reference voc_label_difficult.py)")
    args = ap.parse_args(argv)
    sets = ([tuple(s.split(",")) for s in args.sets] if args.sets
            else (DEFAULT_DIFFICULT_SETS if args.difficult else DEFAULT_SETS))
    prefix = "difficult_" if args.difficult else ""
    cwd = os.getcwd()
    for year, image_set in sets:
        list_file = os.path.join(args.root, f"VOC{year}", "ImageSets", "Main",
                                 f"{image_set}.txt")
        if not os.path.exists(list_file):
            continue
        with open(list_file) as f:
            ids = [l.strip() for l in f if l.strip()]
        with open(f"{prefix}{year}_{image_set}.txt", "w") as out:
            for image_id in ids:
                img = os.path.join(cwd, args.root, f"VOC{year}", "JPEGImages",
                                   f"{prefix}{image_id}.jpg")
                out.write(img + "\n")
                convert_annotation(args.root, year, image_id, args.classes,
                                   difficult_only=args.difficult)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
