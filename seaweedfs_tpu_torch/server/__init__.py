"""The volume-server daemon and the HTTP plumbing it stands on."""
