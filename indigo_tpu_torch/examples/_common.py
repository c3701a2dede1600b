"""What the example scripts share: the device, a sync before a clock
reading, and their command line."""
from __future__ import annotations

import argparse

import torch


def device_of(device):
    """The device an example runs on: ``device``, by default the card."""
    return torch.device("cuda" if device is None else device)


def sync(dev):
    """Wait for the card, so the host clock reads finished work."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def cli(doc, big=False):
    """Keyword arguments of ``main`` from the command line: ``--cpu`` and,
    where the example has a larger size, ``--big``."""
    p = argparse.ArgumentParser(description=doc.splitlines()[0])
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    if big:
        p.add_argument("--big", action="store_true", help="the larger size")
    args = p.parse_args()
    kw = {"device": "cpu"} if args.cpu else {}
    if big:
        kw["big"] = args.big
    return kw
