"""The book chapter MNIST (recognize_digits): the MLP and the conv net against
the reference, and the book's MLP contract, on the port. The shared parity
check and contract runner are ``book_parity`` and ``book_contract`` in
torch_cross.py, which says what they hold."""

import pytest

from torch_cross import (book_contract, book_parity, contract_cases,
                         port_book)  # noqa: F401

CONTRACTS, IDS = contract_cases("test_recognize_digits_mlp_converges")


@pytest.mark.parametrize("chapter", ["digits_mlp", "digits_conv"])
def test_chapter_trains_like_the_reference(chapter):
    book_parity(chapter)


@pytest.mark.parametrize("module,test,kwargs", CONTRACTS, ids=IDS)
def test_book_contract_on_the_port(port_book, tmp_path, module, test,
                                   kwargs):
    book_contract(port_book, tmp_path, module, test, kwargs)


def test_recognize_digits_pserver_variant(port_book):
    """The counterpart of tests/book/test_recognize_digits.py's
    ``test_recognize_digits_pserver_variant`` (the reference book's
    is_local=False axis): the book's MLP, forward+backward only on the
    port's Executor, Adam on the port's parameter server, each pull
    installed into the scope's tensors; the same accuracy contract."""
    import numpy as np
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.distributed import (ParamClient, install_params,
                                              serve)

    book = port_book("test_recognize_digits")
    ps, rpc = serve(optimizer="adam", opt_kwargs={"lr": 0.002},
                    mode="async")
    rpc.serve_in_thread()
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with fluid.program_guard(main, startup):
        img = fluid.layers.data("img", shape=[784])
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        prediction, avg_loss, acc = book.mlp(img, label)
        params_grads = fluid.append_backward(avg_loss)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    pnames = [p.name for p, _ in params_grads]
    client = ParamClient([rpc.address])
    client.init_params({n: scope.find_var(n).numpy() for n in pnames})
    xs, ys = book._digit_arrays()
    batch = 128
    grad_names = [g.name for _, g in params_grads]
    acc_val = 0.0
    try:
        for epoch in range(10):
            accs = []
            for i in range(0, len(xs) - batch + 1, batch):
                install_params(scope, client.pull(),    # recv params
                               device=exe.device)
                vals = exe.run(main, feed={"img": xs[i:i + batch],
                                           "label": ys[i:i + batch]},
                               fetch_list=[acc] + grad_names, scope=scope)
                accs.append(float(vals[0]))
                client.push(dict(zip(pnames, vals[1:])))   # send grads
            acc_val = float(np.mean(accs))
            if acc_val > 0.95:
                break
    finally:
        client.close()
        rpc.shutdown()
    assert acc_val > 0.9, f"pserver MLP failed to converge, acc={acc_val}"
