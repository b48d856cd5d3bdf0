"""Operations and bytes of each kernel and step, from its shapes: what
the algorithm needs, whatever implements it."""
