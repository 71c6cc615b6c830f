"""The admin shell: `weed shell`'s EC commands over HTTP."""
