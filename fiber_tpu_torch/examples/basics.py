"""The smallest possible tour: Process, Queue, Pipe, Manager
(reference: examples/basic_process.py, basic_queue.py, shared_data.py).

Run:  python -m fiber_tpu_torch.examples.basics

The JAX package's ``examples/basics.py`` with the package renamed
(``tests/test_torch_examples.py`` holds it to the original); it
runs on the host only.
"""


import sys


def greeter(name, q):
    q.put(f"hello {name} from a fiber_tpu_torch process")


def doubler(conn):
    while True:
        item = conn.recv()
        if item is None:
            return
        conn.send(item * 2)


def main():
    import fiber_tpu_torch

    # Process + SimpleQueue
    q = fiber_tpu_torch.SimpleQueue()
    p = fiber_tpu_torch.Process(target=greeter, args=("world", q))
    p.start()
    print(q.get(30))
    p.join(30)

    # Pipe
    here, there = fiber_tpu_torch.Pipe()
    p = fiber_tpu_torch.Process(target=doubler, args=(there,))
    p.start()
    here.send(21)
    print("21 doubled remotely ->", here.recv(30))
    here.send(None)
    p.join(30)

    # Manager shared state
    manager = fiber_tpu_torch.Manager()
    shopping = manager.list(["eggs"])
    shopping.append("spam")
    print("shared list ->", list(shopping))
    manager.shutdown()


if __name__ == "__main__":
    sys.exit(main())
