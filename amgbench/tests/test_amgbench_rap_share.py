"""rap_card_mac_share on hand-made runs: the card's share of the recorded
products' multiply-adds, and None where there is nothing to read (off the
card, a program that keeps no product record, no products)."""
import collections
import types

import pytest
import torch

from conftest import REPO

from amgbench import spec

CARD, CPU = torch.device("cuda", 0), torch.device("cpu")
Product = collections.namedtuple("Product", "level engine macs seconds")

PRODUCTS = [Product(0, "host", 100, 0.1), Product(0, "host", 300, 0.2),
            Product(2, "card", 3_000, 0.05), Product(3, "card", 6_600, 0.04)]


def _run(device=CARD, **info):
    return types.SimpleNamespace(device=device,
                                 amg=types.SimpleNamespace(info=types.SimpleNamespace(**info)))


def _read(run):
    return spec.reader(REPO, "rap_card_mac_share")(run)


def test_share_of_the_multiply_adds():
    assert _read(_run(products=PRODUCTS)) == pytest.approx(96.0)
    assert _read(_run(products=PRODUCTS[:2])) == 0.0
    assert _read(_run(products=PRODUCTS[2:])) == 100.0


@pytest.mark.parametrize("run", [_run(device=CPU, products=PRODUCTS), _run(),
                                 _run(products=[]),
                                 _run(products=[Product(0, "host", 0, 0.0)])],
                         ids=["cpu", "no_record", "no_products", "no_macs"])
def test_none_without_data(run):
    assert _read(run) is None
