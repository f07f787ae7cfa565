"""Client protocol, benchmark tree, measurement loop, plans and results."""
