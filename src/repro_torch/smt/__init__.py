"""SMT machine model, workloads, profiling and the closed-race engine."""
