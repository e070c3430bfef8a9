"""THOR asset-name -> semantic-class normalization.

Behavioral equivalent of the reference's name-munging rules
(reference: generate_thor_data.py camel_case_split :595-596,
class_reduction_rule :599-688, process_class_name :691-692), restructured
as data-driven rule tables: the reference encodes each rule as inline
string surgery; here exact-name fixes, substring folds, plural suffixes
and containment folds are declarative so the mapping is auditable.

A copy of ``semantic_abstraction_tpu/datagen/naming.py`` (numpy, host only), so that the
port imports nothing of the JAX package.
"""
from __future__ import annotations

import re

_CAMEL = re.compile(r"[A-Z](?:[a-z]+|[A-Z]*(?=[A-Z]|$))")

# asset-name normalizations applied in order
_EXACT_FIXES = {
    "towl": "towel",
    "plate stack": "plate",
    "book stack": "book",
    "book": "book",
}
_REPLACEMENTS = (
    ("counter top", "countertop"),
    ("fire place", "fireplace"),
    ("base board", "baseboard"),
    ("dish washer", "dishwasher"),
    ("bath tub", "bathtub"),
)
# plural suffixes reduced to singular by dropping one trailing 's'
_PLURAL_SUFFIXES = (
    "bottles", "wires", "windows", "pans", "decals", "cups", "walls",
    "rods", "cans", "lights",
)
# "substring anywhere -> class" folds; checked before/after the
# ceiling-identity rule in reference order
_CONTAINS_FOLDS_PRE = (
    ("cloth", "cloth"),
    ("island", "kitchen island"),
)
_CONTAINS_FOLDS_POST = (
    ("cabinet", "cabinet"),
    ("fridge", "fridge"),
    ("shelf", "shelf"),
    ("shelving", "shelf"),
    ("shelves", "shelf"),
    ("knife", "knife"),
    ("stove", "stove"),
    ("wall", "wall"),
    ("window", "window"),
    ("door", "door"),
)


def camel_case_split(name: str):
    return _CAMEL.findall(name)


def normalize_object_type(object_type: str) -> str:
    """AI2-THOR objectType (CamelCase) -> lower-case spaced class name."""
    return " ".join(c.lower() for c in camel_case_split(object_type))


def class_reduction_rule(raw_class_name: str) -> str:
    """Reduce a raw THOR asset/instance name to a semantic class."""
    name = raw_class_name
    if "FP326:PS_326_" in name:
        name = name.split("FP326:PS_326_")[1]
    # strip instance decorations
    name = (
        name.split("_")[0]
        .split("Height")[0]
        .split("Standard")[-1]
        .split("|")[0]
        .split("Size")[0]
        .split("Done")[0]
    )
    if name.upper() == name:
        return name
    parts = camel_case_split(name)
    if parts:
        name = " ".join(c.lower() for c in parts)
    name = "".join(name.split("mesh")).strip()
    if name.startswith("f "):
        name = name[2:]

    if "ladel" in name or "ladle" in name:
        return "ladle"
    if name in _EXACT_FIXES:
        return _EXACT_FIXES[name]

    # decoration folding: any 'deco'/'decor' prefix not already expanded
    if "deco" in name and not ("decorative" in name or "decoration" in name):
        if "decor" in name:
            name = name.replace("decor", "decoration")
        else:
            name = name.replace("deco", "decoration")
    for old, new in _REPLACEMENTS:
        name = name.replace(old, new)
    if name in _EXACT_FIXES:
        return _EXACT_FIXES[name]
    if name.endswith("rug"):
        return "rug"
    for suffix in _PLURAL_SUFFIXES:
        if name.endswith(suffix):
            return name[:-1]
    if name.endswith("glasses"):
        return name[:-2]
    for sub, folded in _CONTAINS_FOLDS_PRE:
        if sub in name:
            return folded
    if "ceiling" in name:
        return name
    for sub, folded in _CONTAINS_FOLDS_POST:
        if sub in name:
            return folded
    return name


def process_class_name(c: str) -> str:
    return c.split("|")[0].split(" ")[0]
