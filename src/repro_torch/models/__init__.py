"""Model substrate: params, rotary, attention, MLP and transformer assembly."""
