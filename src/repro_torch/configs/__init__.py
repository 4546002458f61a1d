"""Architecture configs of the port (`get_arch`): the dense decoder LMs."""
