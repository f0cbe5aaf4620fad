"""The checker engine of the port: per-run planning (:mod:`.planning`),
device execution (:mod:`.execution`) and their composition
(:mod:`.pipeline`)."""
