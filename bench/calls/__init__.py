"""The calls a traffic mix makes, one module each, found by the mix's ``call`` key.

A module gives ``prepare(ctx)`` (set-up beyond the data), ``warmup(ctx)``,
``next_input(ctx, i)`` (the client's side of request i, inside the window
and outside the request's clock), ``request(ctx, i, inp)`` (the call; the
harness synchronises after it), ``units(ctx)`` (points and steps a
request), ``work(cfg, mix)`` (operations and bytes a request,
``bench/work.py``), ``cache_ok(counters, n)`` and ``release(ctx)``.
"""
