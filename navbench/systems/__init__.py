"""One module a kind of deployment, found by the ``system`` that a
configuration names: ``MODULES`` (the modules of a side it calls),
``Built(pkg, config, world, traffic, device)`` builds one side (the
program or the reference) with its start state ``state0``, and
``tick(built, state, t)`` runs tick t, returning (state, record), where
the record's ``cmd`` holds the (B, 2) commands that the program's entry
returned. That tick is the benchmark's contract with the program: the
planted faults wrap it. So the state tree carries all of the program's
state: ``Built`` holds only what no tick changes, and a tick is a function
of its arguments."""
