"""The catch-up service's cache tiers, as far as the port has them."""
