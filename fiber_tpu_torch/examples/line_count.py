"""Count lines of every example, in parallel — the reference's
smallest Pool demo (reference: examples/line_count.py), unchanged in
spirit: Pool.map of a plain-Python function over a file list.

Run:  python -m fiber_tpu_torch.examples.line_count

The JAX package's ``examples/line_count.py`` with the package renamed
(``tests/test_torch_examples.py`` holds it to the original); it
runs on the host only.
"""


from pathlib import Path


def line_count(fname):
    with open(fname) as f:
        return len(f.readlines())


def main():
    import fiber_tpu_torch

    here = Path(__file__).parent
    files = sorted(str(p) for p in here.glob("*.py"))
    with fiber_tpu_torch.Pool(4) as pool:
        counts = pool.map(line_count, files)
    for f, c in zip(files, counts):
        print(f"{Path(f).name}\t{c}")
    print(f"{len(files)} files counted")


if __name__ == "__main__":
    main()
