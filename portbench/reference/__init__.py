"""Plain references: torch code that imports nothing of the port (nor jax
or the JAX package) and works out each answer again from the inputs a
call was handed. Each module, named after its entry, has `expect(args)`,
the answer; `control(args)`, the same computed one step below what the
configuration guarantees, which has to come out not correct; and
`compare(got, want)`, the numbers that decide `correct`."""
