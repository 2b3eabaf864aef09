"""The published peaks of a device, from `peaks.json`, by JAX's
`device_kind`. A device that is not in the table is an error, not a
default: a share of a guessed peak is no measurement."""

import json
import os

PEAKS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "peaks.json")


def device_peaks(device_kind: str) -> dict:
    with open(PEAKS) as f:
        table = json.load(f)
    if device_kind not in table:
        raise KeyError(f"no published peaks for device {device_kind!r} in "
                       f"{PEAKS}")
    return table[device_kind]
