"""The job modules a traffic mix names by its ``job``: each turns the mix's
parameters into units of work for the window and checks what they
produced against the plain reference."""
