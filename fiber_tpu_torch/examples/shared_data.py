"""Nested managed objects mutated from a worker — the reference's
manager semantics demo (reference: examples/shared_data.py): which
mutations through Namespace/list/dict proxies are visible to the
master, and which need an explicit assign-back because the inner
object is an unmanaged copy.

Run:  python -m fiber_tpu_torch.examples.shared_data

The JAX package's ``examples/shared_data.py`` with the package renamed
(``tests/test_torch_examples.py`` holds it to the original); it
runs on the host only.
"""


def mutate(ns, ls, di):
    ns.x += 1
    # ns.y is a plain list INSIDE the namespace: in-place mutation is
    # lost (the proxy returned a copy)...
    ns.y[0] += 1
    # ...unless the mutated copy is assigned back.
    z = ns.z
    z[0] += 1
    ns.z = z

    ls[0] += 1          # direct managed-list slot: visible
    ls[1][0] += 1       # nested plain list, not assigned back: lost
    inner = ls[2]
    inner[0] += 1
    ls[2] = inner       # assigned back: visible
    ls[3][0] += 1       # nested MANAGED list: direct mutation visible

    di["a"] += 1
    di["nested"][0] += 1        # plain nested, lost
    nested = di["copy"]
    nested[0] += 1
    di["copy"] = nested         # assigned back: visible
    di["managed"][0] += 1       # managed nested: visible


def main():
    import fiber_tpu_torch

    with fiber_tpu_torch.Manager() as manager:
        ns = manager.Namespace()
        ns.x = 0
        ns.y = [0]
        ns.z = [0]
        ls = manager.list([0, [0], [0], manager.list([0])])
        di = manager.dict({"a": 0, "nested": [0], "copy": [0],
                           "managed": manager.list([0])})

        p = fiber_tpu_torch.Process(target=mutate, args=(ns, ls, di))
        p.start()
        p.join()
        assert p.exitcode == 0, p.exitcode

        print(f"ns.x   = {ns.x}  (direct attr: visible)")
        print(f"ns.y   = {ns.y}  (nested, no assign-back: LOST)")
        print(f"ns.z   = {ns.z}  (nested, assigned back: visible)")
        print(f"ls     = {list(ls)[:3]} + [{list(ls[3])}]")
        print(f"di     = a={di['a']} nested={di['nested']} "
              f"copy={di['copy']} managed={list(di['managed'])}")
        assert ns.x == 1 and ns.y == [0] and ns.z == [1]
        assert ls[0] == 1 and ls[1] == [0] and ls[2] == [1]
        assert list(ls[3]) == [1]
        assert di["a"] == 1 and di["nested"] == [0]
        assert di["copy"] == [1] and list(di["managed"]) == [1]
    print("shared data semantics demonstrated")


if __name__ == "__main__":
    main()
