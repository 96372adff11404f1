"""One module a kind of deployment: ``Built(pkg, config, world, traffic,
device)`` builds one side (the program or the reference) and
``tick(built, state, t)`` runs tick t, returning (state, record)."""
