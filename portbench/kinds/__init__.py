"""The traffic kinds' runners, each named by a mix's ``kind``.

A runner's ``execute(run, device, seconds, tracer)`` builds the program from
the run's configuration and the benchmark's weights, warms up every shape of
the mix (set-up), drives the program for ``seconds`` and keeps the outputs it
checks; then ``reference(run, prec, ...)`` computes what the plain reference
gives for the same inputs and ``compare(kept, ref)`` the numbers that decide
``correct``.
"""
