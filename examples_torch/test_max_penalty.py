"""Expected-failure scenario on lcqpow_tpu_torch (the torch version of
``examples/test_max_penalty.py``; reference
``test/examples/test_max_penalty.cpp:49,75-79``): with
``max_penalty_parameter=1`` the warm-up homotopy cannot reach
complementarity and must fail with ``MAX_PENALTY_REACHED``.

Usage: python examples_torch/test_max_penalty.py [--device cpu]
"""

import argparse

import lcqpow_tpu_torch as lt


def main(argv=None):
    p = argparse.ArgumentParser(description="max-penalty failure")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)

    data = lt.make_lcqp(Q=[[2.0, 0.0], [0.0, 2.0]], g=[-2.0, -2.0],
                        L=[[1.0, 0.0]], R=[[0.0, 1.0]], device=args.device)
    sol = lt.solve(data, lt.Options(print_level=lt.PrintLevel.NONE,
                                    max_penalty_parameter=1.0))
    ret = lt.ReturnValue(int(sol.ret))
    print("return:", ret.name)
    lt.print_message(ret)
    assert ret == lt.ReturnValue.MAX_PENALTY_REACHED, ret
    print("expected failure reproduced")


if __name__ == "__main__":
    main()
