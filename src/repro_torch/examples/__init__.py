"""The port's examples: the JAX package's seven ``examples/*.py`` on the
PyTorch/CUDA table, one module each, with the same sizes, prints and
asserts. Each runs on the card unless given ``--device cpu``::

    python -m repro_torch.examples.quickstart [--device cpu]
    python -m repro_torch.examples.resize_demo [--device cpu]
    python -m repro_torch.examples.elastic_churn [--device cpu]
    python -m repro_torch.examples.save_restore_reshard [--device cpu]
    python -m repro_torch.examples.serve_paged [--device cpu]
    python -m repro_torch.examples.serving_router [--device cpu]
    python -m repro_torch.examples.train_smollm [--device cpu]

Each module's ``main(argv=None)`` takes the same arguments.
"""

EXAMPLES = ("quickstart", "resize_demo", "elastic_churn",
            "save_restore_reshard", "serve_paged", "serving_router",
            "train_smollm")


def device_args(doc: str, argv=None):
    """The examples' command line: ``--device`` (default ``cuda``)."""
    import argparse
    ap = argparse.ArgumentParser(description=doc.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    return ap.parse_args(argv)
