"""Flash attention, forward: ``ops`` holds the ``flash_fwd`` kernel's
wrappers (``flash_attention`` on (B, S, H, hd) with grouped KV heads,
``flash_call`` on (BH, S, hd) panels) and launch counter, ``ref`` the
plain f32 attention they are held to."""
